"""The program's spans in a traced window: device operations, host time
and the device's idle gaps charged to the layer of the port that made
them.

The port opens a span (`mvgformer_tpu_torch/utils/profiling.py::span`,
names in its `SPANS`, all `mvg.`) around each of its layers while a
profiler records: host ranges on the profiler's clock, the card's clock.
`reduce` takes the events of a `torch.profiler` window (`prof.events()`)
and gives, for each span name,

  * `calls`, `host_s` (each call's length, summed: inclusive) and `self_s`
    (less the spans it holds on its own thread);
  * `ops` and `device_s`: the device operations (kernels, copies, sets, as
    `trace.traced` counts them) whose launching runtime call lies in the
    span, each charged to the innermost span open on the launching
    thread, or where that thread holds no span (the autograd engine's) to
    the innermost one open on the main thread (the thread of the first
    span) at that instant;
  * `idle_s`: the device's idle gaps, each charged to the span open where
    the gap starts that opened last, on any thread (the main thread's, or
    within its backward the autograd engine's: a layer recomputed there);

and `unspanned` (`ops`, `device_s`, `idle_s`; `unlinked`: the device
operations whose runtime call the window does not hold), so that the
spans' ops plus the unspanned ones are the window's `device_ops`. Times
are the profiler's microseconds, given in seconds.

`trace.record` reduces every traced window's events here once and keeps
`spans` and `unspanned` in the record that the readers of `benchmark/
metrics/` read (`spanned`, `per_unit_ms`, `ops_per_unit`).

`python3 -m benchmark.spans --workload <cell> --seed <n> --seconds <s>`
runs a cell as `benchmark.run --trace 1` does and prints its result line
with the record's spans beside it: `spans`, `unspanned`, the span metrics
(`SPAN_METRICS`, also in the result's `metrics`) and the traced window's
idle seconds. Like `benchmark.run`, it prints no result and exits 3 where
JAX or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
from typing import Dict, Iterable, List, Optional, Tuple

from benchmark import trace

PREFIX = "mvg."
# the runtime calls that launch device operations: CUDA's runtime and
# driver entry points
RUNTIME = ("cuda", "cu")
# the readers of `benchmark/metrics/` that read the spans
SPAN_METRICS = ("dlt_ops_per_frame.serve", "dlt_host_ms.serve",
                "projattn_host_ms.serve", "decoder_host_ms.serve",
                "dlt_ops_per_step.train", "forward_host_ms.train",
                "backward_host_ms.train")


class _Open:
    """The spans of one thread, properly nested: the innermost one open at
    an instant."""

    def __init__(self, spans: List[Tuple[float, float, str]]):
        self.spans = sorted(spans)
        self.starts = [s[0] for s in self.spans]

    def at(self, t: float) -> Optional[Tuple[float, float, str]]:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0:
            if self.spans[i][1] > t:
                return self.spans[i]
            i -= 1
        return None


def reduce(events: Iterable, ranges: Tuple[str, ...] = (),
           top: int = 10) -> dict:
    """The spans of a profiler window's events (see the module)."""
    from torch.autograd import DeviceType

    events = list(events)
    device, host, by_thread, edges = [], {}, {}, []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name in ranges or e.name.startswith(PREFIX):
                continue  # a range's device-side span, not an operation
            device.append((start, end, e.id))
            continue
        edges.append((start, end))
        if e.name.startswith(PREFIX):
            by_thread.setdefault(e.thread, []).append((start, end, e.name))
        elif e.name.startswith(RUNTIME):
            host[e.id] = (e.thread, start)
    opened = {th: _Open(s) for th, s in by_thread.items()}
    main_thread = (min(by_thread, key=lambda th: min(by_thread[th]))
                   if by_thread else None)

    def launched_in(thread, t) -> Optional[str]:
        """The innermost span open on `thread` at t, else on the main
        thread."""
        for th in (thread, main_thread):
            span = opened[th].at(t) if th in opened else None
            if span is not None:
                return span[2]
        return None

    def innermost(t) -> Optional[str]:
        """The span open at t that opened last, on any thread: the
        autograd engine's recompute inside the main thread's backward."""
        open_at = [s for s in (o.at(t) for o in opened.values()) if s]
        return max(open_at)[2] if open_at else None

    out: Dict[str, dict] = {}

    def entry(name):
        return out.setdefault(name, {"calls": 0, "host_s": 0.0,
                                     "self_s": 0.0, "ops": 0,
                                     "device_s": 0.0, "idle_s": 0.0})

    for spans in by_thread.values():
        # each span's length less that of the spans it holds directly
        spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self_us = [end - start for start, end, _ in spans]
        stack: List[int] = []
        for k, (start, end, name) in enumerate(spans):
            while stack and spans[stack[-1]][1] <= start:
                stack.pop()
            if stack:
                self_us[stack[-1]] -= end - start
            stack.append(k)
            e = entry(name)
            e["calls"] += 1
            e["host_s"] += (end - start) / 1e6
        for k, (_, _, name) in enumerate(spans):
            out[name]["self_s"] += self_us[k] / 1e6
    rest = {"ops": 0, "device_s": 0.0, "idle_s": 0.0, "unlinked": 0}
    for start, end, cid in device:
        launch = host.get(cid)
        name = launched_in(*launch) if launch is not None else None
        e = out[name] if name is not None else rest
        e["ops"] += 1
        e["device_s"] += (end - start) / 1e6
        if launch is None:
            rest["unlinked"] += 1
    # the window: from its first event to its last, host or device
    busy = trace.merged([(a, b) for a, b, _ in device])
    lo = min([a for a, _ in edges + busy[:1]], default=0.0)
    hi = max([b for _, b in edges + busy[-1:]], default=0.0)
    gaps = [(a, b) for a, b in zip([lo] + [b for _, b in busy],
                                   [a for a, _ in busy] + [hi]) if b > a]
    idle_s = 0.0
    for a, b in gaps:
        name = innermost(a)
        (out[name] if name is not None else rest)["idle_s"] += (b - a) / 1e6
        idle_s += (b - a) / 1e6
    ranked = sorted(((n, v["idle_s"]) for n, v in out.items()),
                    key=lambda kv: -kv[1])[:top]
    return {"spans": out, "unspanned": rest, "device_ops": len(device),
            "idle_s": idle_s,
            "idle_by_span": [[n, s] for n, s in ranked]}


def spanned(record: dict, prefix: str) -> List[dict]:
    """The entries of `record["spans"]` whose name starts with `prefix`;
    empty where the record holds no spans."""
    return [v for n, v in record.get("spans", {}).items()
            if n.startswith(prefix)]


def per_unit_ms(record: dict, prefix: str, unit: str) -> Optional[float]:
    """The host ms of the spans named `prefix` per frame (`unit` 'frame')
    or step ('step'), on the untraced clock: their traced share of the
    window times the untraced seconds per unit. None where no such span
    ran or the record is not of that unit."""
    entries = spanned(record, prefix)
    if not entries or f"{unit}_s" not in record:
        return None
    host_s = sum(v["host_s"] for v in entries)
    return 1e3 * host_s / record["window_s"] * record[f"{unit}_s"]


def ops_per_unit(record: dict, name: str, unit: str) -> Optional[float]:
    """The device ops charged to span `name` per frame or step; None where
    it did not run."""
    entries = spanned(record, name)
    count = record.get(unit + "s")
    if len(entries) != 1 or not count:
        return None
    return entries[0]["ops"] / count


def main(argv=None) -> int:
    from benchmark import run

    parser = argparse.ArgumentParser(
        description="a cell's traced run with the program's spans")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    run.cache_dirs()
    bench = run.benchmark()
    cell = run.cell_of(bench, args.workload)
    run.require_cards(cell["chips"])
    import torch

    out = run.run_cell(bench, cell, args.seed, args.seconds, True,
                       torch.device("cuda", 0), run.T0)
    if run.loads_forbidden():
        return 3
    record, result = out["record"], out["result"]
    if "spans" not in record:
        raise RuntimeError("the record holds no spans (see standard error)")
    spanned_idle = sum(v["idle_s"] for v in record["spans"].values())
    idle_s = spanned_idle + record["unspanned"]["idle_s"]
    result.update(
        spans=record["spans"], unspanned=record["unspanned"],
        span_metrics={n: m["value"] for n, m in result["metrics"].items()
                      if n in SPAN_METRICS},
        traced={"idle_s": idle_s,
                "spanned_idle_share": spanned_idle / idle_s if idle_s
                else None,
                "units": record.get("frames", record.get("steps"))})
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
