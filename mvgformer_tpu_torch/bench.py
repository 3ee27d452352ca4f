"""Flagship serving throughput on one card, the counterpart of the root
bench.py:

    python -m mvgformer_tpu_torch.bench [--device cpu] [--toy]

The full MVGFormer forward (PoseResNet-50 on 5 views at 960x512, 1024
queries x 15 joints, 4 decoder layers; top-64 queries after layer 1,
point-top-4, the Jacobi DLT; bfloat16, batch 1), weights drawn from a
fixed seed, one synthetic frame made with numpy as the JAX package makes it.

Timing is the counterpart of bench.py's chained `lax.scan`: ITERS frames
run back to back, each frame's views moved by eps, a 0-d device tensor
that is 0 times the sum of the previous frame's pred (it orders the frames
and carries a NaN on, as JAX's carry does); nothing is read back inside
the loop, and the host clock goes around the loop and one synchronize at
its end. After the kernel builds and WARMUP_FRAMES frames, REPEATS such
loops are timed; the value is their median.

Lines before the last, none of them timed: the build with the host
(`host_info`: its CPU, cores, load and microseconds per queued op), the
check (one frame in float32 with TF32 off through the kernels on the card
against the plain path on the CPU, layer 1 at the golden tolerance
classes), the timed frames' checks (shape, finite values, B1 launches per
frame), the synchronizing CUDA operations of one frame, a torch.profiler
window of PROFILE_FRAMES frames (the device's launches per frame and top
ops; its busy time per frame against a timed frame gives the idle share)
and the peak device memory of the timed loops. The last line is
bench.py's JSON object plus the spread, the card and `correct`; a failed
check prints it with `correct` false and exits 1.

`--device cpu` runs the same code with the kernels' plain versions; it
measures no card, so its time keys are null. `--toy` takes the tiny
widths of the root __graft_entry__.py's dry run (TOY) and a short loop
(TOY_LOOP), for a run on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from mvgformer_tpu_torch.config import Config, load_config
from mvgformer_tpu_torch.device import (card_line, resolve_device,
                                        strict_float32)
from mvgformer_tpu_torch.ops import (_build, deform_attn, table_build,
                                     table_gather, window_block, window_dma)
from mvgformer_tpu_torch.utils.profiling import (count_syncs,
                                                 profile_window, synchronize)

# BASELINE.md's estimate of the original torch repo's A100 rate at these
# settings (the root bench.py): a comparison point, not a gate
A100_REFERENCE_FPS_ESTIMATE = 25.0
METRIC = "panoptic_5view_inference_fps_per_chip"
ITERS = 20
REPEATS = 5
WARMUP_FRAMES = 3
PROFILE_FRAMES = 3
THRESHOLD = 0.1
SEED = 0
# the dry run's widths (the root __graft_entry__.py:73-86)
TOY = {"NETWORK.IMAGE_SIZE": [96, 64], "DECODER.d_model": 32,
       "DECODER.dim_feedforward": 64, "DECODER.nhead": 4,
       "DECODER.dec_n_points": 2, "DECODER.num_decoder_layers": 2,
       "DECODER.num_instance": 16, "DATASET.CAMERA_NUM": 3,
       "MULTI_PERSON.MAX_PEOPLE_NUM": 4,
       "POSE_RESNET.NUM_DECONV_FILTERS": [32, 32, 32]}
TOY_LOOP = {"iters": 3, "repeats": 2, "warmup": 1}
# the model path's kernels (the probes' are on no model path)
MODEL_KERNELS = (deform_attn.deform_sample, window_block.window_block_matmul,
                 window_dma.window_block_dma, table_build.build_corner_table,
                 table_gather.gather_reduce_forward,
                 table_gather.gather_reduce_backward)
MODEL_SOURCES = ("deform_sample.cu", "window_block.cu", "window_dma.cu",
                 "table_build.cu", "table_gather.cu", "dlt_jacobi.cu",
                 "point_topm.cu")
# B1's kernel function, as the profiler names it
B1_KERNEL = "deform_sample_fwd_kernel"
HOST_OPS = 2000


def flagship_cfg(toy: bool = False) -> Config:
    """The flagship widths the root scripts set on the default config: 1024
    queries, 5 views at 960x512; with `toy`, TOY on top."""
    cfg = load_config()
    cfg.DECODER.num_instance = 1024
    cfg.DATASET.CAMERA_NUM = 5
    cfg.NETWORK.IMAGE_SIZE = [960, 512]
    if toy:
        for key, value in TOY.items():
            section, name = key.split(".")
            setattr(getattr(cfg, section), name, value)
    return cfg


def bench_cfg(toy: bool = False) -> Config:
    """bench.py's config: the flagship widths, top-64 queries after layer
    1, point-top-4 and the Jacobi DLT, in the default bfloat16."""
    cfg = flagship_cfg(toy)
    cfg.DECODER.inference_topk_queries = 64
    cfg.DECODER.inference_point_topm = 4
    cfg.DECODER.triangulation_method = "jacobi"
    return cfg


def parse_args(argv: Optional[Sequence[str]], doc: str,
               rows: bool = False) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=doc.splitlines()[0])
    if rows:
        parser.add_argument("only", nargs="*", metavar="name-substring",
                            help="run only the rows whose name holds one")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    parser.add_argument("--toy", action="store_true",
                        help="the dry run's tiny widths and a short loop, "
                        "for the CPU")
    return parser.parse_args(list(argv or []))


def frame_loop(toy: bool) -> dict:
    """The chained loop's depth: `time_frames`'s keyword arguments."""
    if toy:
        return dict(TOY_LOOP)
    return {"iters": ITERS, "repeats": REPEATS, "warmup": WARMUP_FRAMES}


def device_name(device: torch.device) -> str:
    """The card's name and power limit, or 'cpu'."""
    return card_line() if device.type == "cuda" else "cpu"


def host_info(device: torch.device, ops: int = HOST_OPS) -> dict:
    """The host this run is on, beside its rates: the CPU's model, the
    cores this process may use, the load average, and the host's
    microseconds per queued op (`ops` in-place adds on a one-element
    tensor on `device`, one synchronize after them, timed the second time
    so that no first use falls inside). A frame is paced by its launches,
    so the last number scales the rate a host can reach."""
    model = None
    try:
        with open("/proc/cpuinfo") as f:
            model = next((line.split(":", 1)[1].strip() for line in f
                          if line.startswith("model name")), None)
    except OSError:
        pass
    x = torch.zeros(1, device=device)
    for _ in range(2):
        synchronize(device)
        t0 = time.perf_counter()
        for _ in range(ops):
            x.add_(1.0)
        synchronize(device)
    us = (time.perf_counter() - t0) / ops * 1e6
    return {"cpu": model, "cores": len(os.sched_getaffinity(0)),
            "load_avg": list(os.getloadavg()), "us_per_op": us}


def build_kernels(device: torch.device) -> None:
    """Build the model path's kernels at once (one nvcc each) before any
    frame, so no build falls inside a warm-up or a timed loop."""
    if device.type == "cuda":
        _build.build_all([_build.CSRC / src for src in MODEL_SOURCES])


def launches() -> Dict[str, int]:
    """Each model kernel's launch count so far."""
    return {fn.__name__: fn.launches for fn in MODEL_KERNELS}


def launches_since(before: Dict[str, int], per: int) -> Dict[str, float]:
    """Each model kernel's launches since `before`, per `per` calls."""
    return {k: (n - before[k]) / per for k, n in launches().items()}


def empty_cache(device) -> None:
    """Free the allocator's cache and restart its peak, between rows."""
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def peak_gib(device) -> Optional[float]:
    """The peak memory allocated on the card (None on the CPU)."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def chained(step: Callable, batch, iters: int):
    """`iters` frames of `step` back to back on `batch`, each frame's views
    moved by eps = 0 * the sum of the previous frame's pred (a 0-d tensor
    on the batch's device); nothing is read back. Returns the last pred,
    the last eps and whether every frame's pred was finite, as device
    tensors."""
    device = batch.views.device
    eps = torch.zeros((), device=device)
    finite = torch.ones((), dtype=torch.bool, device=device)
    pred = None
    for _ in range(iters):
        pred = step(dataclasses.replace(batch, views=batch.views + eps))
        eps = pred.float().sum() * 0.0
        finite = finite & torch.isfinite(pred).all()
    return pred, eps, finite


def time_frames(step: Callable, batch, device: torch.device,
                iters: int = ITERS, repeats: int = REPEATS,
                warmup: int = WARMUP_FRAMES) -> dict:
    """The chained protocol: `warmup` frames, one frame counted for its
    synchronizing operations (on the card), then `repeats` timed loops of
    `iters` frames, each kernel's launches in each loop counted.
    Returns the seconds of each loop, the launches per frame of each
    kernel in each loop, the last pred's shape, whether every timed frame
    was finite with eps 0, the syncs of one frame and the loops' peak
    memory (None on the CPU)."""
    chained(step, batch, warmup)
    synchronize(device)
    syncs = (count_syncs(step, batch)[1] if device.type == "cuda"
             else None)
    synchronize(device)
    empty_cache(device)
    seconds, per_frame, ok = [], [], True
    for _ in range(repeats):
        before = launches()
        t0 = time.perf_counter()
        pred, eps, finite = chained(step, batch, iters)
        synchronize(device)
        seconds.append(time.perf_counter() - t0)
        per_frame.append(launches_since(before, iters))
        ok = ok and bool(finite) and float(eps) == 0.0
    return {"seconds": seconds, "launches_per_frame": per_frame,
            "shape": tuple(pred.shape), "finite": ok, "syncs": syncs,
            "peak_gib": peak_gib(device)}


def spread(rates: List[float], device: torch.device) -> dict:
    """The median, min and max of per-loop rates measured on the card;
    None on the CPU, which measures no card."""
    if device.type != "cuda":
        return {"median": None, "min": None, "max": None}
    return {"median": float(np.median(rates)), "min": float(min(rates)),
            "max": float(max(rates))}


def profile_frames(step: Callable, batch, run: dict, iters: int,
                   device: torch.device) -> dict:
    """A profiler window of PROFILE_FRAMES frames after the timed loops
    (`profile_window`) and the device's idle share of a timed frame: 1 -
    the device's busy time per frame in the window over the median
    seconds per frame of the timed loops. The window's own idle share
    (`window_idle_share`) is larger, since the profiler's host work
    lengthens a frame that the host's launches pace. None on the CPU."""
    if device.type != "cuda":
        return {"profile": None, "device_idle_share": None}
    prof = profile_window(lambda: step(batch), PROFILE_FRAMES,
                          per_launch={"b1": B1_KERNEL})
    prof["window_idle_share"] = prof.pop("device_idle_share")
    busy = prof["device_busy_s"] / PROFILE_FRAMES
    frame = float(np.median(run["seconds"])) / iters
    return {"profile": prof, "device_busy_ms_per_frame": 1e3 * busy,
            "timed_ms_per_frame": 1e3 * frame,
            "device_idle_share": 1.0 - busy / frame}


def compare_layer1(got: dict, want: dict) -> dict:
    """Layer-1 logits and 3D of two runs at the golden tolerance classes
    (logits rtol 1e-3 / atol 2e-3, 3D p99 < 2 mm and max < 6 mm, finite):
    the errors and `ok`."""
    lg = got["pred_logits"].float().cpu().numpy()
    lw = want["pred_logits"].float().cpu().numpy()
    err3d = np.abs(got["pred_poses"].float().cpu().numpy()
                   - want["pred_poses"].float().cpu().numpy())
    p99, mx = float(np.percentile(err3d, 99)), float(err3d.max())
    finite = bool(np.isfinite(lg).all()
                  and torch.isfinite(got["pred_poses"]).all())
    ok = bool(np.allclose(lg, lw, rtol=1e-3, atol=2e-3) and p99 < 2.0
              and mx < 6.0 and finite)
    return {"layer": 1, "logits_max_abs_err": float(np.abs(lg - lw).max()),
            "poses_mm_p99": p99, "poses_mm_max": mx, "finite": finite,
            "ok": ok}


def card_vs_cpu(cfg: Config, device, seed: int = SEED) -> dict:
    """One frame of `cfg` through the model on `device` (the kernels, on
    the card) and through the plain path on the CPU, the same weights and
    frame from `seed`, under inference mode, layer 1's outputs compared
    (`compare_layer1`). Set float32 and TF32 off for the golden classes.
    Returns the two models, batches and layer-1 outputs ('dev', 'cpu'),
    each run's seconds, B1's launches on `device` and the comparison."""
    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.models.mvgformer import MVGFormer

    device = resolve_device(device)
    models, batches, outs, seconds = {}, {}, {}, {}
    before = deform_attn.deform_sample.launches
    for side, dev in (("dev", device), ("cpu", torch.device("cpu"))):
        models[side] = MVGFormer(
            cfg, generator=torch.Generator().manual_seed(seed),
            device=dev).eval()
        batches[side] = make_batch(cfg, batch_size=1, seed=seed,
                                   num_people=3, device=dev)
        with torch.inference_mode():
            t0 = time.perf_counter()
            outs[side] = models[side](batches[side], threshold=THRESHOLD)[0]
            synchronize(dev)
            seconds[side] = time.perf_counter() - t0
        if side == "dev":
            b1 = deform_attn.deform_sample.launches - before
    return {"models": models, "batches": batches, "outs": outs,
            "seconds": seconds, "b1_launches": b1,
            "comparison": compare_layer1(outs["dev"], outs["cpu"])}


def check(cfg: Config, device: torch.device) -> dict:
    """bench's check: `cfg` in float32 with TF32 off (the flags restored
    after), one frame card against CPU; on the card B1 must launch. The
    comparison's fields and `ok`."""
    cfg = dataclasses.replace(cfg, PARALLEL=dataclasses.replace(
        cfg.PARALLEL, COMPUTE_DTYPE="float32"))
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    strict_float32()
    try:
        run = card_vs_cpu(cfg, device)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    res = dict(run["comparison"], dtype="float32",
               dev_s=run["seconds"]["dev"], cpu_s=run["seconds"]["cpu"],
               b1_launches=run["b1_launches"])
    if device.type == "cuda" and run["b1_launches"] == 0:
        res["ok"] = False
    del run
    empty_cache(device)
    return res


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv, __doc__)
    device = resolve_device(args.device)
    from mvgformer_tpu_torch.core.infer import make_eval_step
    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.models.mvgformer import MVGFormer

    def line(name, **fields):
        print(json.dumps({"phase": name, **fields}), flush=True)

    card = device_name(device)
    cfg = bench_cfg(args.toy)
    Q, J = cfg.DECODER.num_instance, cfg.DECODER.num_keypoints
    layers = cfg.DECODER.num_decoder_layers
    t0 = time.perf_counter()
    build_kernels(device)
    line("build", seconds=time.perf_counter() - t0, device=card,
         host=host_info(device))

    checked = check(cfg, device)
    line("check", **checked, device=card)

    model = MVGFormer(cfg, generator=torch.Generator().manual_seed(SEED),
                      device=device)
    batch = make_batch(cfg, batch_size=1, seed=SEED, num_people=3,
                       device=device)
    step = make_eval_step(cfg, model, THRESHOLD)
    loop = frame_loop(args.toy)
    run = time_frames(step, batch, device, **loop)
    # B1 once per decoder layer on the card; the CPU runs the plain version
    want = {**{fn.__name__: 0 for fn in MODEL_KERNELS},
            "deform_sample": layers if device.type == "cuda" else 0}
    frames_ok = (run["shape"] == (1, Q, J, 5) and run["finite"]
                 and all(per == want for per in run["launches_per_frame"]))
    line("frames", shape=list(run["shape"]), finite=run["finite"],
         launches_per_frame=run["launches_per_frame"][-1],
         want_launches_per_frame=want, ok=frames_ok, device=card)
    line("syncs", syncs_per_frame=run["syncs"], device=card)
    line("profile", **profile_frames(step, batch, run, loop["iters"], device),
         device=card)
    line("memory", peak_gib=run["peak_gib"], device=card)

    fps = spread([loop["iters"] / s for s in run["seconds"]], device)
    result = {
        "metric": METRIC, "value": fps["median"], "unit": "frames/s",
        "vs_baseline": (None if fps["median"] is None
                        else fps["median"] / A100_REFERENCE_FPS_ESTIMATE),
        "repeats": loop["repeats"], "frames_per_repeat": loop["iters"],
        "min": fps["min"],
        "max": fps["max"], "device": card,
        "correct": bool(checked["ok"] and frames_ok)}
    print(json.dumps(result), flush=True)
    if not result["correct"]:
        raise SystemExit(1)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
