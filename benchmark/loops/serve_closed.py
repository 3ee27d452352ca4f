"""Closed-loop serving: one client sends a batch of frames, waits for its
pred on the host, then sends the next.

Each unit of work is one batch of `batch` consecutive ring frames: its
views are copied from pinned host memory to the card, the port's serving
entry (`core.infer.make_eval_step`) runs, and the pred (B, Q, J, 5) is
copied back. A unit's latency runs from the start of its placement to its
pred on the host. The rig is fixed, so its tensors are placed once in
set-up. Set-up warms up `warmup_units` units (every shape the window
uses); the window then runs units until `--seconds` have passed, and
counts those whose pred reached the host inside it.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from benchmark import (check, flops, frames, host, program, stats,
                       trace, weights)
from benchmark.peaks import PEAK_FLOPS


def run(ctx: dict) -> dict:
    spec, traffic, device = ctx["spec"], ctx["traffic"], ctx["device"]
    s = spec["settings"]
    cuda = device.type == "cuda"
    B = traffic["batch"]
    marks = [("start", ctx["t0"])]

    def mark(name):
        if cuda:
            torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    mark("process")  # the interpreter, torch, the card's context
    cfg = program.config(spec)
    net = program.model(cfg, device)
    mark("model")
    drawn = weights.draw(weights.float_shapes(net), ctx["seed"], device)
    weights.load(net, drawn)
    mark("weights")
    ring = frames.make_ring(spec, traffic, ctx["seed"], device)
    mark("frames")
    if len(ring) % B:
        raise ValueError(f"a ring of {len(ring)} frames in batches of {B}")
    units = len(ring) // B
    rig = ring.rig_batch(B)
    step = program.eval_step(cfg, net, s["MULTI_PERSON.THRESHOLD"])
    M, J = s["MULTI_PERSON.MAX_PEOPLE_NUM"], s["DECODER.num_keypoints"]

    def unit(i: int):
        first = (i % units) * B
        views = ring.views[first:first + B].to(device, non_blocking=True)
        pred = step(program.batch(views, rig, M, J))
        return list(range(first, first + B)), pred.float().cpu().numpy()

    for i in range(traffic["warmup_units"]):
        unit(i)
    mark("warm-up")
    # the window's host work: one thread, no collector pass inside it
    torch.set_num_threads(1)
    gc.collect()
    gc.freeze()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    watch = host.Window()
    start = time.perf_counter()
    setup_s = start - ctx["t0"]
    print("set-up s: " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:])),
        file=sys.stderr)
    spans, results, i = [], [], 0
    while True:
        a = time.perf_counter()
        out = unit(i)
        b = time.perf_counter()
        if b > start + ctx["seconds"]:
            break
        spans.append((a, b, B))
        results.append(out)
        i += 1
    window = watch.close()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    gc.unfreeze()
    print("window quarters, frames/s: " + ", ".join(
        f"{r:.2f}" for r in stats.quarters(
            [b - start for _, b, _ in spans], B, ctx["seconds"])),
        file=sys.stderr)
    shape = (B, s["DECODER.num_instance"], J, 5)
    failed = sum(B for _, pred in results
                 if pred.shape != shape or not np.isfinite(pred).all())
    fps = stats.rate(spans, ctx["seconds"])
    out = {"attempted": B * len(spans), "failed": failed,
           "metrics": {"serve_fps": fps, "serve_p95_ms": stats.p95_ms(spans),
                       "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
           "memory_peak_bytes": int(peak), "host": window}
    if ctx["trace"]:
        program.mark_backbone(net)
        record = trace.traced(lambda: unit(i), traffic["trace_units"],
                              (program.BACKBONE_RANGE,))
        record.update(
            frames=traffic["trace_units"] * B, frame_s=1.0 / fps,
            flops_per_frame=flops.serve_frame(s),
            peak_flops=PEAK_FLOPS[s["PARALLEL.COMPUTE_DTYPE"]])
        out["record"] = record
    # the program's state is freed before the reference runs
    del step, net
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    chosen = check.sample(len(results), ctx["seed"], traffic["check_units"])
    out["judged"] = [results[k] for k in chosen]
    out["values"] = check.readings(spec, drawn, ring, out["judged"], device)
    if ctx.get("keep"):
        out.update(ring=ring, weights=drawn)
    return out


def control(spec: dict, out: dict, seed: int, device) -> dict:
    """The control's numbers: the reference in the configuration's control
    precision in the program's place on the sampled frames, judged as the
    program is."""
    units = [indices for indices, _ in out["judged"]]
    got = check.control(spec, out["weights"], out["ring"], units, device)
    return check.readings(spec, out["weights"], out["ring"], got, device)
