"""Profiling: stage timers and trace capture.

The port's counterpart of `mvgformer_tpu/utils/profiling.py`: wall-clock
time per named stage (the original repository's AverageMeter timers around
forward stages, with cuda.synchronize-based time_synchronized), and a
`torch.profiler` trace of a block written as a Chrome trace.

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
from collections import defaultdict
from typing import Callable, Dict, Optional

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
