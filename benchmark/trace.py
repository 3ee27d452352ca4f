"""The traced window: a `torch.profiler` trace of the measured loop,
reduced to the record the per-layer metrics read and to the breakdown.

The record holds the window's wall seconds, the device's busy seconds (the
union of every kernel, copy and set interval), the device operations
counted, each device operation's seconds and count by name, and the device
seconds of the benchmark's own profiler ranges (the CUDA time that the
profiler attributes to each range's events).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple


# host events of the profiler's own bookkeeping, which name no gap
PROFILER_OWN = ("Activity Buffer Request",)


def merged(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals, as disjoint intervals in
    order."""
    out: List[List[float]] = []
    for start, end in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def traced(fn: Callable[[], None], units: int,
           ranges: Tuple[str, ...] = ()) -> dict:
    """Trace `units` calls of fn (each ends with its result on the host)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    device, host = [], []
    kernels: Dict[str, List[float]] = {}
    range_s = {name: 0.0 for name in ranges}
    for e in events:
        span = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA and e.name in range_s:
            continue  # a range's device-side span, not an operation
        if e.device_type == DeviceType.CUDA:
            device.append(span)
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += (span[1] - span[0]) / 1e6
            k[1] += 1
        elif e.name not in PROFILER_OWN:
            host.append((span[0], span[1], e.name))
            if e.name in range_s:
                range_s[e.name] += _device_us(e) / 1e6
    if not device:
        raise RuntimeError("the profiler saw no device operation")
    return {"window_s": wall,
            "busy_s": sum(b - a for a, b in merged(device)) / 1e6,
            "device_ops": len(device),
            "kernels": kernels, "ranges": range_s,
            "breakdown": breakdown(kernels, device, host)}


def _device_us(event) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        value = getattr(event, attr, None)
        if value:
            return float(value)
    return 0.0


def breakdown(kernels: Dict[str, List[float]],
              device: List[Tuple[float, float]],
              host: List[Tuple[float, float, str]], top: int = 10) -> dict:
    """The device operations that took the most seconds, and the longest
    idle gaps of the device, each named by the innermost host operation
    running where the gap begins."""
    ops = sorted(((name, v[0]) for name, v in kernels.items()),
                 key=lambda kv: -kv[1])[:top]
    busy = merged(device)
    gaps = sorted(((busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)),
                  key=lambda g: g[0] - g[1])[:top]
    named = []
    for start, end in gaps:
        covering = [h for h in host if h[0] <= start < h[1]]
        name = (min(covering, key=lambda h: h[1] - h[0])[2] if covering
                else "host, no operation open")
        named.append([name, (end - start) / 1e6])
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n[:120], s] for n, s in named]}
