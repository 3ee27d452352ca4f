"""Profiling: stage timers and trace capture.

The port's counterpart of `mvgformer_tpu/utils/profiling.py`: wall-clock
time per named stage (the original repository's AverageMeter timers around
forward stages, with cuda.synchronize-based time_synchronized), and a
`torch.profiler` trace of a block written as a Chrome trace; and on the
card, the synchronizing operations a call makes (`count_syncs`) and the
device's busy and idle time over a profiler window (`profile_window`).

PyTorch returns from a call on the card before the device finishes, so
`StageTimer.stage` and `StageTimer.time_fn` end with a synchronize of the
device the stage's outputs live on: a stage's time is its host time and
its device time up to the synchronize.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
import warnings
from collections import defaultdict
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import torch


def first_tensor(obj) -> Optional[torch.Tensor]:
    """The first tensor in a (nested) tuple, list, dict or dataclass."""
    if isinstance(obj, torch.Tensor):
        return obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    elif isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        for item in obj:
            t = first_tensor(item)
            if t is not None:
                return t
    return None


def synchronize(device) -> None:
    """Wait for the work queued on `device` (nothing to wait for on the
    CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class StageTimer:
    """Accumulates wall-clock seconds per named stage."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, device=None):
        """Time the enclosed block; it ends with a synchronize of `device`
        (the device its outputs live on; None or the CPU: none)."""
        start = time.perf_counter()
        yield
        synchronize(device)
        self.totals[name] += time.perf_counter() - start
        self.counts[name] += 1

    def time_fn(self, name: str, fn: Callable, *args, force: bool = True,
                **kwargs):
        """Run fn, wait for the device of its first output tensor (with
        `force`), and record the time."""
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        if force:
            t = first_tensor(out)
            synchronize(None if t is None else t.device)
        self.totals[name] += time.perf_counter() - start
        self.counts[name] += 1
        return out

    def summary(self) -> Dict[str, float]:
        """Mean seconds per call of each stage."""
        return {k: self.totals[k] / max(self.counts[k], 1)
                for k in sorted(self.totals)}

    def format(self) -> str:
        return " | ".join(f"{k}={v * 1000:.1f}ms"
                          for k, v in self.summary().items())


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a `torch.profiler` trace of the enclosed block (the card's
    kernels too where there is one) into <log_dir>/trace.json, a Chrome
    trace (chrome://tracing, Perfetto). log_dir defaults to
    mvgformer_trace under the temporary directory."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "mvgformer_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


SYNC_WARNING = "called a synchronizing CUDA operation"


def count_syncs(fn: Callable, *args, **kwargs) -> Tuple[object, int]:
    """fn(*args, **kwargs) under torch.cuda.set_sync_debug_mode("warn"):
    its result and the number of synchronizing CUDA operations it made
    (each a warning; a call the host waits on cannot be queued ahead).
    Needs a CUDA build of torch."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum(str(w.message).startswith(SYNC_WARNING) for w in caught)


def busy_seconds(spans: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals in microseconds,
    in seconds."""
    busy_us, last = 0.0, None
    for start, end in sorted(spans):
        if last is None or start > last:
            busy_us += end - start
            last = end
        elif end > last:
            busy_us += end - last
            last = end
    return busy_us / 1e6


def profile_window(fn: Callable, runs: int,
                   per_launch: Optional[Mapping[str, str]] = None) -> dict:
    """torch.profiler over `runs` calls of fn() on the card: the device's
    busy time (the union of its kernel, copy and set intervals) and idle
    share of the window's host wall time, its launches per call, the top
    device ops by device time per call, and for each label of
    `per_launch` the device ms per launch of the kernels whose name holds
    its substring (`<label>_device_ms_per_launch`, None if none ran). The
    profiler's own host work lengthens the window, so the idle share is an
    upper bound. Raises if the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (end - start) / 1e3, n + 1)
    if not spans:
        raise RuntimeError("the profiler saw no device time")
    busy = busy_seconds(spans)
    if busy > wall:
        raise RuntimeError(f"the profiler counted {busy} s of device time "
                           f"in a {wall} s window")
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    out = {"runs": runs, "wall_s": wall, "device_busy_s": busy,
           "device_idle_share": 1.0 - busy / wall,
           "device_launches_per_run": len(spans) / runs,
           "top_device_ops": [{"op": k[:90], "ms_per_run": ms / runs,
                               "launches_per_run": n / runs}
                              for k, (ms, n) in ops[:8]]}
    for label, substring in (per_launch or {}).items():
        hits = [v for k, v in by_name.items() if substring in k]
        out[f"{label}_device_ms_per_launch"] = (
            sum(ms for ms, _ in hits) / sum(n for _, n in hits)
            if hits else None)
    return out
