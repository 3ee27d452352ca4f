"""Training steps queued back to back through the state, as the port's
loop runs them: `core.train.make_train_step` on batches of `batch`
consecutive ring frames, each batch's views placed from pinned host
memory, its targets (the frame's people, their visibility in each view)
made on the card in set-up.

Set-up builds the step and its state once, then drives that same object
through `check_steps` steps on the ring's first batches: their losses are
read, the optimizer's first moments after the first step give its first
gradients, and the parameters after the last give the change. It then
runs `warmup_steps` more, which the check does not read. The window
then queues steps until `--seconds` have passed and one synchronize ends
it; the rate is all its steps over all its time. Once the window has
closed and the program's state is freed, the plain reference follows the
checked steps from the same weights, frames and dropout seeds.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from benchmark import flops, frames, host, program, stats, trace, weights
from benchmark.peaks import PEAK_FLOPS
from benchmark.reference import geometry as G
from benchmark.reference import train as ref_train
from benchmark.reference import precision
from benchmark.reference.precision import Float32, products

B1 = ref_train.B1


def targets_of(ring, indices, device) -> dict:
    """The targets of ring frames `indices` on the card: joints (B, M, J,
    3), their visibility (people present), the count, and each view's 2D
    visibility (in front of the camera, inside the full image)."""
    idx = list(indices)
    joints = torch.from_numpy(ring.joints[idx]).to(device)
    B, M, J, _ = joints.shape
    count = torch.from_numpy(ring.counts[idx].astype(np.int32)).to(device)
    vis = (torch.arange(M, device=device)[None] < count[:, None]).float()
    rig = ring.rig
    V = rig["R"].shape[0]
    pts = joints.reshape(B, 1, M * J, 3).expand(B, V, M * J, 3)
    pix = G.project_points(pts, *(rig[k] for k in "RTfckp"))
    depth = torch.einsum("vij,bvnj->bvni", rig["R"],
                         pts - rig["T"].transpose(-1, -2))[..., 2]
    wh = rig["centers"][:, None] * 2.0
    seen = (depth > 0) & (pix >= 0).all(-1) & (pix < wh).all(-1)
    vis2d = seen.reshape(B, V, M, J).float() * vis[:, None, :, None]
    return {"joints_3d": joints, "joints_3d_vis": vis[..., None].expand(
        B, M, J).contiguous(), "num_person": count, "joints_vis_2d": vis2d}


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
    names = ref_train.trainable(drawn)
    mark("weights")
    ring = frames.make_ring(spec, traffic, ctx["seed"], device)
    units = len(ring) // B
    rig = ring.rig_batch(B)
    M, J = s["MULTI_PERSON.MAX_PEOPLE_NUM"], s["DECODER.num_keypoints"]
    feeds = [targets_of(ring, range(u * B, u * B + B), device)
             for u in range(units)]
    mark("frames")
    state, step = program.train_step(cfg, net)
    dropout_seeds = torch.Generator().manual_seed(int(ctx["seed"]))

    def unit(i: int):
        nonlocal state
        first = (i % units) * B
        views = ring.views[first:first + B].to(device, non_blocking=True)
        state, metrics = step(state, program.batch(
            views, rig, M, J, feeds[i % units]), dropout_seeds)
        return metrics

    checked = traffic["check_steps"]
    losses = []
    for i in range(checked):
        losses.append({k: float(v) for k, v in unit(i).items()})
        if i == 0:
            first = {k: (state.opt_state.mu[k] / (1 - B1)).detach().clone()
                     for k in names}
    params = dict(net.named_parameters())
    after = {k: params[k].detach().clone() for k in names}
    warm = checked + traffic["warmup_steps"]
    for i in range(checked, warm):
        unit(i)
    mark("warm-up")
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
    n, queued = warm, []
    while time.perf_counter() - start < ctx["seconds"]:
        last = unit(n)
        n += 1
        queued.append(time.perf_counter() - start)
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - start
    window = watch.close()
    print("window quarters, steps/s queued: " + ", ".join(
        f"{r:.2f}" for r in stats.quarters(queued, 1, ctx["seconds"])),
        file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    gc.unfreeze()
    steps = n - warm
    finite = bool(torch.isfinite(last["total"]))
    out = {"attempted": steps, "failed": 0 if finite else steps,
           "metrics": {"train_steps_per_s": steps / window_s,
                       "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
           "memory_peak_bytes": int(peak), "host": window}
    if ctx["trace"]:
        traced = traffic["trace_units"]
        record = trace.traced(lambda: unit(n), traced)
        record.update(steps=traced, step_s=window_s / steps,
                      flops_per_step=flops.train_step(s),
                      peak_flops=PEAK_FLOPS[s["PARALLEL.COMPUTE_DTYPE"]])
        out["record"] = record
    # the program's state is freed before the reference runs
    del step, state, net, params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    batches = [(ring.frame(range(u * B, u * B + B), device), feeds[u])
               for u in range(checked)]
    got = {"losses": losses, "first": first, "after": after}
    out["values"] = readings(spec, drawn, names, batches, ctx["seed"], got)
    if ctx.get("keep"):
        out.update(ring=ring, weights=drawn, batches=batches, names=names)
    return out


def readings(spec, drawn, names, batches, seed, got) -> dict:
    """The numbers read against the reference in float32: the largest
    relative gap of a checked step's loss (`loss_gap`) and of its
    classification term (`ce_gap`), and the gap of the first gradient and
    of the change after the checked steps by the worst leaf (`grad_gap`,
    `change_gap`) and by the median leaf (`grad_gap_p50`,
    `change_gap_p50`; `reference/train.leaf_gaps`)."""
    ref = follow(spec, drawn, names, batches, seed, Float32)
    grads = ref_train.leaf_gaps(got["first"], ref["first"], ref["first"])
    change = ref_train.leaf_gaps(
        {k: got["after"][k] - drawn[k] for k in names},
        {k: ref["after"][k] - drawn[k] for k in names}, ref["first"])
    return {
        "loss_gap": max(abs(a["total"] - b["total"]) / abs(b["total"])
                        for a, b in zip(got["losses"], ref["losses"])),
        "ce_gap": max(abs(a["loss_ce"] - b["loss_ce"]) / abs(b["loss_ce"])
                      for a, b in zip(got["losses"], ref["losses"])),
        "grad_gap": max(grads), "grad_gap_p50": float(np.median(grads)),
        "change_gap": max(change),
        "change_gap_p50": float(np.median(change))}


def control(spec: dict, out: dict, seed: int, device) -> dict:
    """The control's numbers: the reference in the configuration's control
    precision in the program's place for the checked steps, judged as the
    program is."""
    got = follow(spec, out["weights"], out["names"], out["batches"], seed,
                 precision.control(spec))
    return readings(spec, out["weights"], out["names"], out["batches"], seed,
                    got)


def follow(spec, drawn, names, batches, seed, prec) -> dict:
    """The reference's checked steps (TF32 off), or the control's."""
    with products(prec.tf32):
        steps, first, after = ref_train.run_steps(
            spec, drawn, names, batches, torch.Generator().manual_seed(
                int(seed)), prec)
    return {"losses": steps, "first": first, "after": after}
