"""The traced window: a `torch.profiler` trace of the measured loop,
reduced to the record the per-layer metrics read and to the breakdown.

The record holds the window's wall seconds, the device's busy seconds (the
union of every kernel, copy and set interval), the device operations
counted, each device operation's seconds and count by name, and the device
seconds of the benchmark's own profiler ranges (the CUDA time that the
profiler attributes to each range's events). From the program it holds

  * `spans` and `unspanned`: the window's device operations, host time and
    idle gaps charged to the program's `mvg.` spans (`benchmark/spans.py`),
    and `breakdown["idle_by_span"]`. Left out, with a line on standard
    error, where the spans' operations and the unspanned ones do not add
    up to `device_ops`;
  * `counters`: each of the program's counters (`program.counters`) moved
    by the traced units, as the difference of a snapshot after them and
    one before.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple


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
    from torch.profiler import ProfilerActivity, profile

    from benchmark import program

    torch.cuda.synchronize()
    before = program.counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counters = moved(before, program.counters())
    t1 = time.perf_counter()
    events = prof.events()
    t2 = time.perf_counter()
    out = record(events, wall, ranges, counters)
    print(f"trace: {len(events)} events read in {t2 - t1:.3f} s, "
          f"reduced in {time.perf_counter() - t2:.3f} s", file=sys.stderr)
    return out


def record(events: Iterable, wall: float, ranges: Tuple[str, ...] = (),
           counters: Optional[Mapping[str, int]] = None) -> dict:
    """The record of a traced window's profiler events (`prof.events()`),
    its wall seconds, and the program's counters that it moved."""
    from torch.autograd import DeviceType

    from benchmark import spans

    events = list(events)
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
    out = {"window_s": wall,
           "busy_s": sum(b - a for a, b in merged(device)) / 1e6,
           "device_ops": len(device),
           "kernels": kernels, "ranges": range_s,
           "breakdown": breakdown(kernels, device, host),
           "counters": dict(counters or {})}
    # `reduce` charges each device operation it counts to a span or to
    # `unspanned`
    got = spans.reduce(events, ranges)
    if got["device_ops"] == out["device_ops"]:
        out.update(spans=got["spans"], unspanned=got["unspanned"])
        out["breakdown"]["idle_by_span"] = got["idle_by_span"]
    else:
        print(f"spans left out: they charge {got['device_ops']} device "
              f"operations, the trace counts {out['device_ops']}",
              file=sys.stderr)
    return out


def moved(before: Mapping[str, int], after: Mapping[str, int]
          ) -> Dict[str, int]:
    """Each counter's difference, after less before, by name."""
    return {name: after.get(name, 0) - before.get(name, 0)
            for name in sorted(set(before) | set(after))}


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
