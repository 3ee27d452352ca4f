"""Profiling: the port's spans, trace capture and the card's counters.

The port's counterpart of `mvgformer_tpu/utils/profiling.py`. `span(name)`
marks a layer of the program on `torch.profiler`'s timeline, the clock of
the card's activity, while a profiler records, and costs one flag check
otherwise; `SPANS` names every span the program opens. `trace()` writes a
profiler trace of a block as a Chrome trace, the spans above the ops and
kernels they launch. `COUNTERS` is the port's counter registry: `count(name,
n)` adds to a named count that the host already knows (no device read), and
the benchmark's traced runs record each count that their units moved. On
the card, `count_syncs` counts the synchronizing operations a call makes
and `profile_window` the device's busy and idle time over a profiler
window.
"""

from __future__ import annotations

import collections
import contextlib
import os
import tempfile
import time
import warnings
from typing import Callable, Iterable, Mapping, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

# every span the program opens: the step of serving (`core/infer.py`) or
# training (`core/train.py`), and inside it the model's layers; LAYER is
# the name of decoder layer l (from 0), `LAYER.format(l)`;
# `mvg.point_topm` is point-top-m inside ProjAttn (`ops/projattn.py`);
# `mvg.vp.*` are VoxelPose's (`models/voxelpose.py`), `mvg.lt.*` the
# volumetric Learnable Triangulation model's (`models/volumetric.py`)
LAYER = "mvg.layer{}"
SPANS = ("mvg.step", "mvg.backbone", "mvg.init", LAYER, "mvg.project",
         "mvg.projattn", "mvg.topk", "mvg.dlt", "mvg.pred", "mvg.match",
         "mvg.forward", "mvg.loss", "mvg.backward", "mvg.update",
         "mvg.vp.volume", "mvg.vp.cpn", "mvg.vp.propose", "mvg.vp.prn",
         "mvg.vp.softargmax", "mvg.point_topm", "mvg.lt.pelvis",
         "mvg.lt.volume", "mvg.lt.v2v", "mvg.lt.softargmax")

# the port's counter registry, by name: VoxelPose's `voxelpose.root_volumes`
# and `voxelpose.prn_volumes` (the volumes its two V2V networks computed),
# `volumetric.view_volumes` (the per-view feature volumes that the
# Learnable Triangulation model sampled), `point_topm.launches`
# (`ops/point_topm.py`) and `dlt_jacobi.backward_launches` (the DLT's
# backward kernel, `ops/dlt_jacobi.py`)
COUNTERS: collections.Counter = collections.Counter()


def count(name: str, n: int = 1) -> None:
    """Add `n` to the registry's count `name`. `n` is a number the host
    holds already (a shape, a batch size), never a device value, so that
    counting adds no synchronization."""
    COUNTERS[name] += n


class _Off:
    """The span of a block that no profiler records: nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A context manager that marks the enclosed block as `name` on the
    profiler's timeline while a profiler records (the autograd profiler's
    enabled flag, which every thread reads), and does nothing otherwise.

    The range is a function-scope record (torch's `_RecordFunctionFast`):
    it nests the host's ops and launches under it and, unlike a
    `record_function` user range, draws no range of its own on the card's
    timeline, so a trace counts the same device operations and busy time
    with the spans as without them."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


def synchronize(device) -> None:
    """Wait for the work queued on `device` (nothing to wait for on the
    CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


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
