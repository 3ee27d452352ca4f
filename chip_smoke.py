"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Runs from the root of a checkout, needs one CUDA card and nvcc (CUDA_HOME or
/usr/local/cuda), and builds the port's kernels from the checkout's sources
into build/kernels/. Phases, each printed on its own line; any failure
exits non-zero:

  1. find the card and print its name and power limit;
  2. build the six sources at once (deformable sampling, the two window
     kernels, the corner-table build, the table gather-reduce forward and
     backward, and the probe kernels' gather forms), one nvcc each, and
     print ptxas's registers, stack and spill bytes per kernel instance;
  3. hold the deformable-sampling kernel against its plain PyTorch version
     on the card at the flagship shapes (dense layer 1, Lq 15360 at P 4 and
     8, and the top-64 layers, Lq 960 at P 4; float32 and bfloat16, edge
     and non-finite locations included), check that they take the vector
     instances, and time both with CUDA events (`ms`) and the kernel on the
     device alone (`device_ms`);
  4. hold the two window kernels against their plain versions on the card,
     on the level operands of the flagship rig's layer-1 plans (K = 28, and
     K = 20 under layer1_offset_clamp 4), P 4 and 8, float32 and bfloat16,
     offsets inside and outside the halo, each launched twice for the same
     bits and timed as in phase 3; then the whole window_sample with each
     kernel against the deformable-sampling kernel on in-halo offsets;
  5. the flagship-width model (random weights from a fixed seed, float32,
     TF32 off): one frame through the kernel path on the card and through
     the plain path on the CPU, layer-1 logits and 3D compared at the
     golden tolerance classes;
  6. the same with the windowed layer-1 path (impls 'pallas' and
     'pallas_dma'), and on the card the windowed model against the gather
     model at init;
  7. serve: bfloat16, batch 1, one camera rig, distinct synthetic frames
     through core.infer.make_eval_step; shape, NaN and kernel-launch checks,
     frames/s and peak device memory;
  8. serve the windowed path the same way, once per impl, with the plan
     built once, and the escaped mass read per frame. Serving launches no
     training kernel;
  9. the corner-table build (B2) against its plain version on the flagship
     value, every level, float32 and bfloat16: bit for bit, and two
     launches the same bits; both timed, the kernel also on the device
     alone;
 10. the table gather-reduce (B3) forward and backward against the plain
     versions at one training layer's shape (40 pairs, 122,880 samples per
     level, rows from random locations with border and missing samples),
     float32 and bfloat16, the backward launched twice and compared bit
     for bit, untouched gradient rows exactly 0; both timed, the backward
     also in its parts (the sort of its wrapper, the bare flattened and
     per-pair sorts, the kernels alone on sorted samples), and the peak
     memory of one layer's forward and backward through the kernels and
     through plain autograd;
 11. the corner sampler (B2 + B3) against the deformable-sampling kernel
     (B1), the same contract, float32;
 12. one training step of a toy config in float32 (TF32 off), kernels on
     the card against the plain path on the CPU: every loss term and every
     gradient;
 13. train: the flagship training config (bfloat16, batch 1, gt match,
     Jacobi DLT, remat, dropout 0.1), 2 warm-up and 5 timed steps through
     core.train.make_train_step on batches made before the clock starts;
     finite losses, the backbone unchanged, non-zero sampler gradients,
     the launch counts the design predicts, steps/s and peak memory; then
     torch.profiler over 2 more steps gives B3's device ms per launch, and
     the first of them records the first decoder layer's B3 operands (a
     wrapper around ops.sampling.deform_gather_reduce that calls through);
 13b. B3 on those captured operands of the training step: against the
     plain versions as in phase 10, the samples per table row of each
     level (max, p99, share in rows over the backward's tile), and timed;
 14. the probe kernels (row gather, windowed gather, take-along, scale,
     table slots) against their plain versions at the probes' shapes and
     at B3's flagship level-0 row, float32 and bfloat16, bit for bit
     (scale exact), one case each timed beside its plain version and its
     library call: `ms` one call between two events (host path and device
     together), `device_ms` 50 back-to-back calls with the stream held
     until all are enqueued (tools/launch_cost.py), and the host's us per
     call;
 15. the ported probes (mvgformer_tpu_torch/tools/probes/), each main once
     at 3 timed runs, with the probe kernels' counts set to 0 before and
     read after; their results go to build/probes.jsonl;
 16. cli_train: the port's train CLI (mvgformer_tpu_torch.run.train.main)
     on configs/synthetic_ap_ablation.yaml at its full width, 3 steps on 8
     frames in a temporary OUTPUT_DIR under build/: finite losses, 24 / 24
     / 12 training-kernel launches per step, B1 once per layer per eval
     batch, the logged eval of epoch 0, the checkpoint read back with
     weights_only=True; steps/s, the Prefetcher's wait share, peak memory;
 17. cli_validate: the port's validate CLI (mvgformer_tpu_torch.run.
     validate.main) on that checkpoint, its first frame bit for bit
     against make_eval_step on the checkpoint's weights; then on
     configs/panoptic/knn5-lr4-q1024.yaml at full width with synthetic
     frames, through the gather and through 'pallas_dma': frames/s of the
     CLI's loop, the Prefetcher's wait share, B1 / B5 launches per frame,
     the escaped mass; and the Prefetcher's placed batches against
     synchronous copies, bit for bit. Each CLI run sets the kernel counts
     to 0 before it and reads them after; the kernel rows carry them as
     `cli_launches`.

Phase 10 also holds F.embedding_bag, the library call of B3's function,
against B3's plain versions and times it. The models, batches and window
plans are made on the card by their entry points (device "cuda"). With
--parent DIR (an unpacked parent checkout), B1, B2, B4 and B5 of DIR and of
this checkout are also timed in turns by tools/launch_cost.py before the
table.

The last three lines are the kernel table (each kernel's launches on its
path, worst error, ms, device_ms where measured, plain ms, library ms or
why there is none, its bound from utils/bounds.py on the timed inputs, and
for B1, B2, B4 and B5 ptxas's report and, with --parent, the parent's
times), the card, and the device, as JSON. The `ranking` phase before them
orders the kernels for later work (`ranking`).
"""

import contextlib
import importlib
import json
import math
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from mvgformer_tpu_torch.ops import (_build, deform_attn, gather_forms,
                                     sampling, table_build, table_gather,
                                     window_block, window_dma,
                                     window_sampling)
from mvgformer_tpu_torch.tools.launch_cost import (B1_SHAPES,
                                                   FLAGSHIP_LEVELS,
                                                   device_ms, level_views,
                                                   sampling_inputs,
                                                   window_inputs)
from mvgformer_tpu_torch.tools.probes.probe_pallas_gather import flat_rows
from mvgformer_tpu_torch.utils import bounds, yardsticks

REPO = Path(__file__).resolve().parent
SPATIAL_SHAPES = FLAGSHIP_LEVELS
N_VIEWS, HEADS, HEAD_DIM = 5, 8, 32
TRAIN_LQ, TRAIN_P = 1024 * 15, 8  # dense training layer: Q*J queries
SEED = 0
THRESHOLD = 0.1
SERVE_FRAMES, SERVE_WARMUP = 6, 2
WINDOW_FRAMES = 10  # distinct frames per windowed impl, 2 of them warm-up
TRAIN_STEPS, TRAIN_WARMUP = 7, 2
SOURCES = ("deform_sample.cu", "window_block.cu", "window_dma.cu",
           "table_build.cu", "table_gather.cu", "gather_forms.cu")
IMPL_KERNEL = {"pallas": window_block.window_block_matmul,
               "pallas_dma": window_dma.window_block_dma}
TRAIN_KERNELS = (table_build.build_corner_table,
                 table_gather.gather_reduce_forward,
                 table_gather.gather_reduce_backward)
ALL_KERNELS = (deform_attn.deform_sample, *IMPL_KERNEL.values(),
               *TRAIN_KERNELS)
WINDOW_WORK = {window_block.window_block_matmul: bounds.window_block,
               window_dma.window_block_dma: bounds.window_dma}
PLAIN = {window_block.window_block_matmul:
         window_block.window_block_matmul_plain,
         window_dma.window_block_dma: window_dma.window_block_dma_plain}
# window plans of the rig: K = 28 (default halo 10) and K = 20 (clamp 4)
WINDOW_CLAMPS = {28: None, 20: 4.0}
PROBES = ("probe_pallas_gather", "probe_pallas_gather2",
          "probe_mosaic_gather_forms", "probe_onehot_parts",
          "probe_sorted_gather_parts", "probe_table_kernel_forms")
PROBE_RUNS = ("--runs", "3", "--warmup", "1")
# the CLI phases: the train CLI on the from-scratch ablation config, the
# validate CLI on it and at the flagship width with synthetic frames
ABLATION_CFG = REPO / "configs" / "synthetic_ap_ablation.yaml"
FLAGSHIP_CFG = REPO / "configs" / "panoptic" / "knn5-lr4-q1024.yaml"
CLI_TRAIN_ARGS = ("--max_steps", "3", "DATASET.MAX_DATA_NUM=8")
FLAGSHIP_VALIDATE = ("DATASET.TEST_DATASET=synthetic",
                     "DATASET.MAX_DATA_NUM=8",
                     "DECODER.inference_topk_queries=64",
                     "DECODER.inference_point_topm=4",
                     "DECODER.triangulation_method=jacobi",
                     "PARALLEL.COMPUTE_DTYPE=bfloat16")
WINDOWED_VALIDATE = ("DECODER.layer1_windowed_sampling=true",
                     "DECODER.layer1_window_impl=pallas_dma")
# launch_cost's kernel sets timed against the parent (--parent)
PARENT_KERNELS = "deform,window_block,window_dma,table_build"
NO_LIBRARY = {
    "deform_sample": "none: F.grid_sample is the bilinear read of one "
                     "level and head only; the sum over levels and points "
                     "and the attention weights are further calls",
    "window_block_matmul": "none: no single call reads tent-weighted "
                           "windows by block index",
    "window_block_dma": "none: no single call reads tent-weighted windows "
                        "at block origins",
    "build_corner_table": "none: a pad, four slices and a concatenation",
    "table_slots": "none: a pad, four slices and a concatenation",
    "gather_reduce_backward": "none in bfloat16: PyTorch's CUDA "
                              "embedding_bag has no bfloat16 backward for "
                              "per-sample weights; float32 beside it",
}
PROBE_ROWS = (
    (gather_forms.row_gather, "tools/probes/probe_pallas_gather.py:40",
     ["tools/probes/probe_pallas_gather.py:70 (make_onehot_kernel)",
      "tools/probes/probe_pallas_gather2.py:84 (onehot_kernel)",
      "tools/probes/probe_mosaic_gather_forms.py:17 (f2, f3, f6)"],
     "torch.index_select"),
    (gather_forms.window_gather, "tools/probes/probe_onehot_parts.py:41",
     ["tools/probes/probe_sorted_gather_parts.py:116 (kernel)"],
     "torch.index_select"),
    (gather_forms.take_along, "tools/probes/probe_pallas_gather2.py:60",
     ["tools/probes/probe_pallas_gather.py:40 (take_eq)",
      "tools/probes/probe_mosaic_gather_forms.py:17 (f1, f4, f5)"],
     "torch.gather"),
    (gather_forms.scale, "tools/probes/probe_pallas_gather2.py:45", [],
     "torch.mul"),
    (gather_forms.table_slots, "tools/probes/probe_table_kernel_forms.py:151",
     [], None),
)


def excess_ms(row):
    """The time the path spent above the kernel's bound in this run: each
    shape's launches (a row without `by_shape` is one shape) at that
    shape's time per launch (device_ms where measured, else ms) less its
    bound."""
    return sum(p["launches"] * (p.get("device_ms", p["ms"]) - p["bound_ms"])
               / p.get("timed_launches", 1)
               for p in row.get("by_shape") or [row])


def kernel_row(fn, source, replaces, launches, max_abs_err, ms, plain_ms,
               library_ms, work, at, timed_launches=1, also=(), library=None,
               by_shape=None, **extra):
    """One entry of the kernels line. `ms` (and `device_ms`, where given)
    is the time of `timed_launches` launches (3 where it sums the levels).
    `by_shape` lists the shapes the path launches the kernel at, each with
    its launches, times and bound; the row's own fields are its first.
    excess_ms: see `excess_ms`."""
    row = {"name": fn.__name__, "route": "cuda",
           "source": f"mvgformer_tpu_torch/csrc/{source}",
           "replaces": replaces, "launches": launches,
           "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": work.bound_ms, "bound_by": work.bound_by,
           "library_ms": library_ms, "at": at,
           "timed_launches": timed_launches}
    if library_ms is None:
        row["library"] = NO_LIBRARY.get(fn.__name__, "none")
    else:
        row["library"] = library
    if also:
        row["also_replaces"] = list(also)
    if by_shape:
        row["by_shape"] = list(by_shape)
    row.update(extra)
    row["excess_ms"] = excess_ms(row)
    return row


def vs_library(row):
    """(kernel time / library time, the clock) of a row with a library
    call: on the device clock (device_ms against library_device_ms) where
    the row and its library both have one, else on the event clock (ms
    against library_ms); None without a library call."""
    if row["library_ms"] is None:
        return None
    if "device_ms" in row and "library_device_ms" in row:
        return row["device_ms"] / row["library_device_ms"], "device_ms"
    return row["ms"] / row["library_ms"], "ms"


def ranking(kernels):
    """The order in which later work takes the kernels: first those slower
    than their library call (`vs_library`), by factor; then the rest by
    excess_ms, the time their path spends above their bounds in this
    run."""
    factor = {r["name"]: vs_library(r) for r in kernels}
    slower = sorted((r for r in kernels if factor[r["name"]] is not None
                     and factor[r["name"]][0] > 1.0),
                    key=lambda r: -factor[r["name"]][0])
    rest = sorted((r for r in kernels if r not in slower),
                  key=lambda r: -r["excess_ms"])
    return ([{"name": r["name"], "slower_than_library_by":
              factor[r["name"]][0], "clock": factor[r["name"]][1]}
             for r in slower]
            + [{"name": r["name"], "excess_ms": r["excess_ms"]}
               for r in rest])


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def flagship_cfg(dtype: str):
    """The widths of configs/panoptic/knn5-lr4-q1024.yaml with the serving
    settings of bench.py: top-64 queries, point-top-4, Jacobi DLT."""
    from mvgformer_tpu_torch.config import load_config

    cfg = load_config(str(REPO / "configs" / "panoptic"
                          / "knn5-lr4-q1024.yaml"))
    cfg.DECODER.inference_topk_queries = 64
    cfg.DECODER.inference_point_topm = 4
    cfg.DECODER.triangulation_method = "jacobi"
    cfg.PARALLEL.COMPUTE_DTYPE = dtype
    return cfg


def cuda_ms(fn, runs=20, warmup=3):
    """Median milliseconds of fn() over `runs` CUDA-event-timed calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def check_kernel(card):
    """Phase 3: kernel against the plain version on the card. Returns the
    worst float32 error and, per shape of a served frame (B1_SHAPES,
    bfloat16), ms, device_ms, plain ms and the compulsory work."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst_f32, serving = 0.0, {}
    for Lq, P in ((15360, 4), (15360, 8), (960, 4)):
        for dtype in (torch.float32, torch.bfloat16):
            value, loc, aw = sampling_inputs(Lq, P, dtype, gen)
            out = deform_attn.deform_sample(value, SPATIAL_SHAPES, loc, aw)
            torch.cuda.synchronize()
            ref = sampling.deform_sample(value.float(), SPATIAL_SHAPES, loc,
                                         aw.float())
            err = (out.float() - ref).abs().max().item()
            if dtype == torch.float32:
                ok = err <= 1e-4
                worst_f32 = max(worst_f32, err)
            else:
                ok = torch.allclose(out.float(), ref, atol=2e-2, rtol=2e-2)

            def kernel():
                return deform_attn.deform_sample(value, SPATIAL_SHAPES, loc,
                                                 aw)

            ms = cuda_ms(kernel)
            dev_ms, host_us = device_ms(kernel)
            plain_ms = cuda_ms(lambda: sampling.deform_sample(
                value, SPATIAL_SHAPES, loc, aw))
            vec = _build.vector_width(HEAD_DIM, value.element_size(), value,
                                      loc, aw, out)
            phase("kernel_vs_plain", N=N_VIEWS, Lq=Lq, H=HEADS, D=HEAD_DIM,
                  L=len(SPATIAL_SHAPES), P=P, dtype=str(dtype),
                  elements_per_thread=vec, max_abs_err=err, ok=bool(ok),
                  ms=ms, device_ms=dev_ms, host_us=host_us,
                  plain_ms=plain_ms, card=card)
            if not ok:
                fail(f"kernel disagrees with the plain version: Lq={Lq} "
                     f"P={P} {dtype} max abs err {err}")
            if vec == 1:
                fail(f"the flagship shape Lq={Lq} P={P} {dtype} took the "
                     f"generic instance")
            if (Lq, P) in B1_SHAPES and dtype == torch.bfloat16:
                serving[Lq] = {
                    "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                    "work": bounds.deform_sample(value, SPATIAL_SHAPES, loc,
                                                 aw)}
    return worst_f32, serving


def window_setup(clamp):
    """The flagship rig's layer-1 plan (on the card) and static centers
    (on the host)."""
    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.models.mvgformer import (
        build_layer1_window_plan, layer1_centers_px)

    cfg = flagship_cfg("float32")
    cfg.DECODER.layer1_offset_clamp = clamp
    batch = make_batch(cfg, batch_size=1, seed=SEED, num_people=3,
                       cam_seed=SEED)
    return (build_layer1_window_plan(cfg, batch.view_data),
            layer1_centers_px(cfg, batch.view_data))


def check_window_kernels(card):
    """Phase 4: each window kernel against its plain version on the level
    operands of the flagship plans, then window_sample with each kernel
    against the deformable-sampling kernel; one line per (K, P, dtype).
    Returns, per kernel, the worst float32 error and the summed ms / plain
    ms / compulsory work over the three levels at bfloat16, K = 28, P = 4
    (the serving shape)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    stats = {fn: {"max_abs_err": 0.0} for fn in PLAIN}
    for K, clamp in WINDOW_CLAMPS.items():
        plan, centers_px = window_setup(clamp)
        if plan.levels[0].K != K:
            fail(f"the plan's window is {plan.levels[0].K}, expected {K}")
        for P in (4, 8):
            for dtype in (torch.float32, torch.bfloat16):
                value, loc, aw = window_inputs(centers_px, plan.halo, P,
                                               dtype, gen, escape=True)
                kernels = {}
                for impl, kernel in IMPL_KERNEL.items():
                    levels = [check_window_level(kernel, call, dtype)
                              for call in window_sampling.level_calls(
                                  value, SPATIAL_SHAPES, loc, aw, plan,
                                  impl=impl)]
                    kernels[kernel.__name__] = levels
                    errs = [lv["max_abs_err"] for lv in levels]
                    if dtype == torch.float32:
                        stats[kernel]["max_abs_err"] = max(
                            stats[kernel]["max_abs_err"], *errs)
                    if (K, P, dtype) == (28, 4, torch.bfloat16):
                        stats[kernel].update(
                            ms=sum(lv["ms"] for lv in levels),
                            device_ms=sum(lv["device_ms"] for lv in levels),
                            plain_ms=sum(lv["plain_ms"] for lv in levels),
                            work=bounds.total([
                                WINDOW_WORK[kernel](*call.args, **call.kwargs)
                                for call in window_sampling.level_calls(
                                    value, SPATIAL_SHAPES, loc, aw, plan,
                                    impl=impl)]))
                sample = check_window_sample(value, centers_px, plan, P,
                                             dtype, gen)
                phase("window_kernels_vs_plain", K=K, P=P, dtype=str(dtype),
                      Kx=plan.levels[0].Kx, halo=plan.halo, kernels=kernels,
                      window_sample_vs_deform_sample=sample, card=card)
                bad = [name for name, levels in kernels.items()
                       if not all(lv["ok"] for lv in levels)]
                bad += [f"window_sample {impl}" for impl, r in sample.items()
                        if not r["ok"]]
                if bad:
                    fail(f"disagreement at K={K} P={P} {dtype}: {bad}")
        del plan
        torch.cuda.empty_cache()
    return stats


def check_window_level(kernel, call, dtype):
    """One level's window kernel call against its plain version (float32,
    on the same operands), and both timed."""
    if call.fn is not kernel:
        fail(f"level call goes to {call.fn}, expected {kernel.__name__}")
    out = call.fn(*call.args, **call.kwargs)
    same_bits = torch.equal(out, call.fn(*call.args, **call.kwargs))
    torch.cuda.synchronize()
    ref = PLAIN[kernel](call.args[0].float(), *call.args[1:], **call.kwargs)
    err = (out.float() - ref).abs().max().item()
    if dtype == torch.float32:
        ok = err <= 1e-4
    else:
        ok = torch.allclose(out.float(), ref, atol=2e-2, rtol=2e-2)
    del out, ref
    data, rel = call.args[:2]
    if _build.vector_width(call.kwargs["D"], data.element_size(), data,
                           rel) == 1:
        fail(f"{kernel.__name__} took the generic instance on the plan's "
             f"level operands ({dtype})")
    dev_ms, host_us = device_ms(lambda: call.fn(*call.args, **call.kwargs))
    return {"rows": call.args[1].shape[0],
            "max_abs_err": err, "ok": bool(ok) and same_bits,
            "bit_identical": same_bits,
            "ms": cuda_ms(lambda: call.fn(*call.args, **call.kwargs)),
            "device_ms": dev_ms, "host_us": host_us,
            "plain_ms": cuda_ms(lambda: PLAIN[kernel](
                *call.args, **call.kwargs), runs=5, warmup=1)}


def check_window_sample(value, centers_px, plan, P, dtype, gen):
    """window_sample through each window kernel against deform_sample
    through the deformable-sampling kernel, on in-halo offsets."""
    _, loc, aw = window_inputs(centers_px, plan.halo, P, dtype, gen,
                               escape=False)
    ref = deform_attn.deform_sample(value.float(), SPATIAL_SHAPES, loc, aw)
    results = {}
    for impl in IMPL_KERNEL:
        out, escaped = window_sampling.window_sample(
            value, SPATIAL_SHAPES, loc, aw, plan, impl=impl)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        if dtype == torch.float32:
            ok = err <= 1e-4
        else:
            ok = torch.allclose(out.float(), ref, atol=2e-2, rtol=2e-2)
        escaped = escaped.item()
        results[impl] = {"max_abs_err": err, "escaped_mass": escaped,
                         "ok": bool(ok) and escaped <= 1e-5}
    return results


def compare_layer1(name, got, want, card, **fields):
    """Layer-1 logits and 3D of two runs at the golden tolerance classes."""
    lg, lw = got["pred_logits"].cpu().numpy(), want["pred_logits"].cpu().numpy()
    logit_err = float(np.abs(lg - lw).max())
    logits_ok = bool(np.allclose(lg, lw, rtol=1e-3, atol=2e-3))
    err3d = np.abs(got["pred_poses"].cpu().numpy()
                   - want["pred_poses"].cpu().numpy())
    p99, mx = float(np.percentile(err3d, 99)), float(err3d.max())
    finite = bool(np.isfinite(lg).all()
                  and torch.isfinite(got["pred_poses"]).all())
    phase(name, layer=1, logits_max_abs_err=logit_err, poses_mm_p99=p99,
          poses_mm_max=mx, finite=finite, card=card, **fields)
    if not (logits_ok and p99 < 2.0 and mx < 6.0 and finite):
        fail(f"{name}: the two runs disagree on layer 1")


def check_slice(card):
    """Phase 5: kernel path on the card against the plain path on the CPU,
    flagship width, float32 with TF32 off. Returns the two models and the
    frame for phase 6."""
    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.models.mvgformer import MVGFormer

    cfg = flagship_cfg("float32")
    # the same seed gives the same weights and frame on either device
    model_cpu = MVGFormer(cfg, generator=torch.Generator().manual_seed(SEED),
                          device="cpu").eval()
    model_gpu = MVGFormer(
        cfg, generator=torch.Generator().manual_seed(SEED)).eval()
    batch = make_batch(cfg, batch_size=1, seed=SEED, num_people=3,
                       device="cpu")
    gpu_batch = make_batch(cfg, batch_size=1, seed=SEED, num_people=3)
    before = deform_attn.deform_sample.launches
    with torch.inference_mode():
        t0 = time.perf_counter()
        gpu = model_gpu(gpu_batch, threshold=THRESHOLD)[0]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cpu = model_cpu(batch, threshold=THRESHOLD)[0]
        t2 = time.perf_counter()
    if deform_attn.deform_sample.launches == before:
        fail("the card's forward did not launch the kernel")
    compare_layer1("slice_kernel_vs_plain", gpu, cpu, card, gpu_s=t1 - t0,
                   cpu_s=t2 - t1)
    return cfg, model_cpu, model_gpu, batch, gpu_batch, gpu


def check_windowed_slice(card, cfg, model_cpu, model_gpu, batch, gpu_batch,
                         gather):
    """Phase 6: the windowed layer-1 path, kernels on the card against the
    plain path on the CPU, for each impl; and on the card the windowed
    model against the gather model at init (exact while the offsets stay
    inside the halo)."""
    from mvgformer_tpu_torch.models.mvgformer import build_layer1_window_plan

    for impl, kernel in IMPL_KERNEL.items():
        cfg.DECODER.layer1_window_impl = impl
        plan = build_layer1_window_plan(cfg, gpu_batch.view_data)
        cpu_plan = build_layer1_window_plan(cfg, batch.view_data,
                                            device="cpu")
        before = kernel.launches
        with torch.inference_mode():
            t0 = time.perf_counter()
            gpu = model_gpu(gpu_batch, threshold=THRESHOLD,
                            window_plan=plan)[0]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cpu = model_cpu(batch, threshold=THRESHOLD,
                            window_plan=cpu_plan)[0]
            t2 = time.perf_counter()
        if kernel.launches == before:
            fail(f"the card's windowed forward did not launch "
                 f"{kernel.__name__}")
        escaped = gpu["escaped_mass"].item()
        compare_layer1("windowed_slice_kernel_vs_plain", gpu, cpu, card,
                       impl=impl, escaped_mass=escaped,
                       escaped_mass_cpu=cpu["escaped_mass"].item(),
                       gpu_s=t1 - t0, cpu_s=t2 - t1)
        compare_layer1("windowed_vs_gather_on_card", gpu, gather, card,
                       impl=impl)
    del model_gpu
    torch.cuda.empty_cache()


def serve(card, cfg, model, frames, impl=None):
    """Phases 7 and 8: the serving path at bfloat16, through the gather
    (impl None) or the windowed layer 1. Every kernel count is set to 0
    first; returns the counts after the run."""
    from mvgformer_tpu_torch.core.infer import make_eval_step
    from mvgformer_tpu_torch.models.mvgformer import build_layer1_window_plan

    Q, J = cfg.DECODER.num_instance, cfg.DECODER.num_keypoints
    layers = cfg.DECODER.num_decoder_layers
    plan = None
    t_plan = time.perf_counter()
    if impl is not None:
        cfg.DECODER.layer1_window_impl = impl
        plan = build_layer1_window_plan(cfg, frames[0].view_data)
    t_plan = time.perf_counter() - t_plan
    step = make_eval_step(cfg, model, THRESHOLD, window_plan=plan,
                          with_escape_telemetry=True)
    counters = ALL_KERNELS
    window = IMPL_KERNEL.get(impl)
    # launches per frame: every layer through the deformable-sampling
    # kernel, or layer 1 through the window kernel (one launch per level);
    # none of the training sampler's
    want_per_frame = {deform_attn.deform_sample: layers - (impl is not None)}
    if window is not None:
        want_per_frame[window] = len(SPATIAL_SHAPES)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    times, escaped = [], []
    for i, frame in enumerate(frames):
        t0 = time.perf_counter()
        pred, esc = step(frame)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        escaped.append(esc.item())
        if tuple(pred.shape) != (1, Q, J, 5):
            fail(f"pred shape {tuple(pred.shape)}")
        if torch.isnan(pred).any():
            fail(f"NaN in the pred of frame {i}")
        for fn in counters:
            want = want_per_frame.get(fn, 0) * (i + 1)
            if fn.launches != want:
                fail(f"{fn.launches} launches of {fn.__name__} after "
                     f"{i + 1} frames, expected {want}")
    launches = {fn.__name__: fn.launches for fn in counters}
    steady = times[SERVE_WARMUP:]
    phase("serve" if impl is None else "serve_windowed", impl=impl,
          frames=len(frames), batch=1, dtype="bfloat16",
          frames_per_s=len(steady) / sum(steady), first_frame_s=times[0],
          plan_s=t_plan if impl is not None else None,
          peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
          escaped_mass_max=max(escaped), kernel_launches=launches, card=card)
    if impl is not None and max(escaped) >= 1e-5:
        fail(f"escaped mass {max(escaped)} at init with the unclamped plan")
    return launches


def check_table_build(card):
    """Phase 9: B2 against its plain version on the flagship value, bit for
    bit, and two launches the same bits; returns, for bfloat16 and summed
    over the three levels, ms, device_ms, plain ms and the compulsory
    work."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    len_in = sum(h * w for h, w in SPATIAL_SHAPES)
    stats = {}
    for dtype in (torch.float32, torch.bfloat16):
        value = torch.randn(N_VIEWS, len_in, HEADS, HEAD_DIM, device="cuda",
                            generator=gen).to(dtype)
        views = level_views(value, SPATIAL_SHAPES)
        equal = all(torch.equal(table_build.build_corner_table(v),
                                table_build.build_corner_table_plain(v))
                    for v in views)
        same_bits = all(torch.equal(table_build.build_corner_table(v),
                                    table_build.build_corner_table(v))
                        for v in views)
        torch.cuda.synchronize()
        ms = sum(cuda_ms(lambda v=v: table_build.build_corner_table(v))
                 for v in views)
        dev_ms = sum(device_ms(lambda v=v: table_build.build_corner_table(
            v))[0] for v in views)
        plain_ms = sum(cuda_ms(lambda v=v: table_build.build_corner_table_plain(
            v), runs=5, warmup=1) for v in views)
        phase("table_build_vs_plain", N=N_VIEWS, H=HEADS, D=HEAD_DIM,
              levels=SPATIAL_SHAPES, rows=[
                  (h + 2) * table_build.padded_width(w)
                  for h, w in SPATIAL_SHAPES],
              dtype=str(dtype), bitwise_equal=equal,
              bit_identical=same_bits, ms=ms, device_ms=dev_ms,
              plain_ms=plain_ms, card=card)
        if not (equal and same_bits):
            fail(f"table_build differs from its plain version or between "
                 f"two launches ({dtype})")
        stats[dtype] = (ms, dev_ms, plain_ms, bounds.total([
            bounds.table_build(N_VIEWS * HEADS, h, w, HEAD_DIM,
                               value.element_size())
            for h, w in SPATIAL_SHAPES]))
    return stats[torch.bfloat16]


def training_layer_inputs(dtype, gen):
    """value, locations and weights of one dense training layer (Lq = 1024
    queries x 15 joints, P = 8) with border and far-outside locations; the
    non-finite ones of `sampling_inputs` are made far-outside, since only
    finite locations reach the table rows."""
    value, loc, aw = sampling_inputs(TRAIN_LQ, TRAIN_P, dtype, gen)
    loc = torch.nan_to_num(loc, nan=5.0, posinf=50.0, neginf=-50.0)
    return value, loc, aw


def layer_peak_gib(fn, tables, samples, cts):
    """Peak device memory (GiB above what was allocated before) of one
    layer's gather-reduce forward and backward through `fn`."""
    tbls = [t.detach().requires_grad_(True) for t in tables]
    w4s = [w.detach().requires_grad_(True) for _, w in samples]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    outs = [fn(t, idx, w) for t, (idx, _), w in zip(tbls, samples, w4s)]
    torch.autograd.backward(outs, cts)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    del outs, tbls, w4s
    torch.cuda.empty_cache()
    return peak


def check_table_gather(card):
    """Phase 10: B3 forward and backward against the plain versions at one
    training layer's shape, and beside them F.embedding_bag, the library
    call of B3's function, held against the plain versions once. Returns,
    per kernel, the float32 worst error and ms, and the bfloat16 ms, plain
    ms, library ms and compulsory work summed over the three levels."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    fwd, bwd = (table_gather.gather_reduce_forward,
                table_gather.gather_reduce_backward)
    stats = {fwd: {"max_abs_err": 0.0}, bwd: {"max_abs_err": 0.0}}
    for dtype in (torch.float32, torch.bfloat16):
        value, loc, aw = training_layer_inputs(dtype, gen)
        with torch.no_grad():
            tables, _ = table_build.build_corner_tables(
                value.transpose(1, 2), SPATIAL_SHAPES)
            samples = sampling.corner_samples(SPATIAL_SHAPES, loc, aw, dtype)
        cts = [torch.randn(idx.shape + (HEAD_DIM,), device="cuda",
                           generator=gen).to(dtype) for idx, _ in samples]
        errs = {fwd: 0.0, bwd: 0.0, "bwd_rel": 0.0}
        ok = True
        bit_identical = True
        for tbl, (idx, w4), ct in zip(tables, samples, cts):
            level_ok, level_errs, same = check_gather_level(tbl, idx, w4, ct)
            ok &= level_ok
            bit_identical &= same
            for k, v in level_errs.items():
                errs[k] = max(errs[k], v)
        times = {
            "fwd_ms": sum(cuda_ms(lambda a=a: fwd(*a)) for a in zip(
                tables, *zip(*samples))),
            "plain_fwd_ms": sum(cuda_ms(
                lambda a=a: table_gather.deform_gather_reduce_plain(*a),
                runs=5, warmup=1) for a in zip(tables, *zip(*samples))),
            "bwd_ms": sum(cuda_ms(lambda a=a: bwd(*a)) for a in zip(
                tables, *zip(*samples), cts)),
            "plain_bwd_ms": sum(cuda_ms(
                lambda a=a: table_gather.gather_reduce_backward_plain(*a),
                runs=5, warmup=1) for a in zip(tables, *zip(*samples), cts)),
            **backward_parts(tables, samples, cts),
        }
        library = library_times(tables, samples, cts)
        work = {fwd: bounds.total([bounds.table_gather_forward(t, i)
                                   for t, (i, _) in zip(tables, samples)]),
                bwd: bounds.total([bounds.table_gather_backward(t, i)
                                   for t, (i, _) in zip(tables, samples)])}
        peaks = {
            "peak_gib_kernel_autograd": layer_peak_gib(
                table_gather.deform_gather_reduce, tables, samples, cts),
            "peak_gib_plain_autograd": layer_peak_gib(
                table_gather.deform_gather_reduce_plain, tables, samples,
                cts),
        }
        phase("table_gather_vs_plain", NH=N_VIEWS * HEADS,
              S_per_level=TRAIN_LQ * TRAIN_P, D=HEAD_DIM,
              table_rows=[t.shape[1] for t in tables], dtype=str(dtype),
              fwd_max_abs_err=errs[fwd], bwd_max_abs_err=errs[bwd],
              bwd_max_err_per_max_grad=errs["bwd_rel"],
              bwd_bit_identical=bit_identical, ok=bool(ok), **times,
              **library,
              fwd_bound_ms=work[fwd].bound_ms,
              bwd_bound_ms=work[bwd].bound_ms, **peaks, card=card)
        if not (ok and bit_identical):
            fail(f"table_gather disagrees with its plain versions or "
                 f"between two launches ({dtype})")
        if dtype == torch.float32:
            stats[fwd].update(max_abs_err=errs[fwd], ms_f32=times["fwd_ms"],
                              library_ms_f32=library["library_fwd_ms"])
            stats[bwd].update(max_abs_err=errs[bwd], ms_f32=times["bwd_ms"],
                              library_ms_f32=library["library_bwd_ms"])
        else:
            stats[fwd].update(ms=times["fwd_ms"],
                              plain_ms=times["plain_fwd_ms"],
                              library_ms=library["library_fwd_ms"],
                              work=work[fwd])
            stats[bwd].update(ms=times["bwd_ms"],
                              plain_ms=times["plain_bwd_ms"],
                              library_ms=library["library_bwd_ms"],
                              work=work[bwd], sort_ms=times["sort_ms"],
                              kernel_only_ms=times["bwd_kernel_only_ms"],
                              bit_identical=bit_identical, **peaks)
        del tables, samples, cts, value, loc, aw
        torch.cuda.empty_cache()
    return stats


def check_gather_level(tbl, idx, w4, ct):
    """B3 forward and backward on one level's operands against the plain
    versions in float32 (f32: forward 1e-5, backward 1e-4 of the largest
    gradient; bf16: 2e-2 of the same scales), the backward launched twice
    and compared bit for bit, and the rows no sample touches exactly 0.
    Returns (ok, worst errors, bit-identical)."""
    fwd, bwd = (table_gather.gather_reduce_forward,
                table_gather.gather_reduce_backward)
    out = fwd(tbl, idx, w4)
    g_tbl, g_w4 = bwd(tbl, idx, w4, ct)
    again = bwd(tbl, idx, w4, ct)
    torch.cuda.synchronize()
    same = torch.equal(g_tbl, again[0]) and torch.equal(g_w4, again[1])
    del again
    f32 = (tbl.float(), idx, w4.float())
    ref = table_gather.deform_gather_reduce_plain(*f32)
    ref_t, ref_w = table_gather.gather_reduce_backward_plain(*f32, ct.float())
    exact = tbl.dtype == torch.float32
    err = (out.float() - ref).abs().max().item()
    errs = {fwd: err, bwd: 0.0, "bwd_rel": 0.0}
    ok = err <= 1e-5 if exact else torch.allclose(out.float(), ref,
                                                  atol=2e-2, rtol=2e-2)
    for got, want in ((g_tbl, ref_t), (g_w4, ref_w)):
        err = (got.float() - want).abs().max().item()
        scale = want.abs().max().item()
        errs[bwd] = max(errs[bwd], err)
        errs["bwd_rel"] = max(errs["bwd_rel"], err / scale)
        ok &= (err <= 1e-4 * scale if exact else torch.allclose(
            got.float(), want, atol=2e-2 * scale, rtol=2e-2))
    NH, R, _ = tbl.shape
    touched = torch.zeros(NH * R, dtype=torch.bool, device=idx.device)
    k = idx.long()
    on = (k >= 0) & (k < R)
    rows = (torch.arange(NH, device=idx.device)[:, None] * R + k)[on]
    touched[rows] = True
    ok &= bool((g_tbl.reshape(NH * R, -1)[~touched] == 0).all())
    return bool(ok), errs, bool(same)


def backward_parts(tables, samples, cts):
    """B3 backward's parts summed over the levels: the sort of its wrapper
    (row_segments: the keys, one flattened stable sort and a binary search
    for the offsets); the bare flattened sort and the bare sort along each
    pair's rows (the alternative), alike without keys or offsets; and the
    kernels alone on sorted samples."""
    segs = [table_gather.row_segments(idx, t.shape[1])
            for t, (idx, _) in zip(tables, samples)]
    rows = [torch.where((idx >= 0) & (idx < t.shape[1]), idx, t.shape[1])
            for t, (idx, _) in zip(tables, samples)]
    return {
        "sort_ms": sum(cuda_ms(lambda a=(idx, t.shape[1]):
                               table_gather.row_segments(*a))
                       for t, (idx, _) in zip(tables, samples)),
        "sort_flat_only_ms": sum(cuda_ms(lambda g=g: torch.sort(
            g.keys, stable=True)) for g in segs),
        "sort_per_pair_ms": sum(cuda_ms(lambda r=r: torch.sort(
            r, dim=-1, stable=True)) for r in rows),
        "bwd_kernel_only_ms": sum(cuda_ms(
            lambda a=a, g=g: table_gather.gather_reduce_backward(
                *a, segments=g))
            for a, g in zip(zip(tables, *zip(*samples), cts), segs)),
    }


def library_times(tables, samples, cts):
    """F.embedding_bag over each level (utils/yardsticks.py): held once
    against B3's plain versions (forward in either dtype, backward in
    float32: the CUDA embedding_bag has no bfloat16 backward for
    per-sample weights), then its forward and, in float32, its autograd
    backward timed and summed over the levels."""
    fwd_ms, bwd_ms = 0.0, None
    dtype = tables[0].dtype
    for tbl, (idx, w4), ct in zip(tables, samples, cts):
        weight, rows, offsets, psw = yardsticks.embedding_bag_operands(
            tbl, idx, w4)
        NH = tbl.shape[0]
        if dtype == torch.float32:
            weight = weight.detach().requires_grad_(True)
            psw = psw.detach().requires_grad_(True)
        out = yardsticks.embedding_bag_reduce(weight, rows, offsets, psw, NH)
        ref = table_gather.deform_gather_reduce_plain(tbl.float(), idx,
                                                      w4.float())
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        if not torch.allclose(out.detach().float(), ref, atol=tol, rtol=tol):
            fail(f"F.embedding_bag is not B3's forward ({dtype})")
        with torch.no_grad():
            fwd_ms += cuda_ms(lambda: yardsticks.embedding_bag_reduce(
                weight, rows, offsets, psw, NH))
        if dtype == torch.float32:
            got_t, got_w = torch.autograd.grad(out, (weight, psw), ct,
                                               retain_graph=True)
            ref_t, ref_w = table_gather.gather_reduce_backward_plain(
                tbl, idx, w4, ct)
            for got, want in ((got_t.view(ref_t.shape), ref_t),
                              (got_w.view(ref_w.shape), ref_w)):
                if (got - want).abs().max() > 1e-4 * want.abs().max():
                    fail("F.embedding_bag's backward is not B3's")
            bwd_ms = (bwd_ms or 0.0) + cuda_ms(lambda: torch.autograd.grad(
                out, (weight, psw), ct, retain_graph=True))
        del out, ref, weight, rows, offsets, psw
    return {"library_fwd_ms": fwd_ms, "library_bwd_ms": bwd_ms}


def check_corner_sampler(card):
    """Phase 11: the corner sampler (B2 + B3) against B1 on the same
    float32 inputs of a dense training layer. The locations lie on a 2^-16
    grid, so loc * size - 0.5 is exact in float32 whether or not the
    compiler fuses the multiply-add (B1's nvcc does, torch does not): an
    unfused rounding at x ~ 240 px moves a bilinear weight by ~1e-5."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    value, loc, aw = training_layer_inputs(torch.float32, gen)
    loc = torch.round(loc * 2.0 ** 16) / 2.0 ** 16
    with torch.no_grad():
        got = sampling.deform_sample_corner(value, SPATIAL_SHAPES, loc, aw)
        want = deform_attn.deform_sample(value, SPATIAL_SHAPES, loc, aw)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ms = cuda_ms(lambda: sampling.deform_sample_corner(
            value, SPATIAL_SHAPES, loc, aw))
        b1_ms = cuda_ms(lambda: deform_attn.deform_sample(
            value, SPATIAL_SHAPES, loc, aw))
    phase("corner_sampler_vs_deform_sample", N=N_VIEWS, Lq=TRAIN_LQ,
          P=TRAIN_P, dtype="float32", max_abs_err=err, ok=err <= 1e-5,
          ms=ms, deform_sample_ms=b1_ms, card=card)
    if err > 1e-5:
        fail(f"the corner sampler differs from deform_sample by {err}")


def toy_train_cfg():
    """A small float32 training config: 96x64 images, 3 views, d_model 32,
    4 heads, 2 points, 2 layers, 16 queries, Jacobi DLT, no dropout (the
    CPU's and the card's generators draw different masks)."""
    from mvgformer_tpu_torch.config import load_config

    cfg = load_config()
    cfg.NETWORK.IMAGE_SIZE = [96, 64]
    cfg.DECODER.d_model = 32
    cfg.DECODER.dim_feedforward = 64
    cfg.DECODER.nhead = 4
    cfg.DECODER.dec_n_points = 2
    cfg.DECODER.num_decoder_layers = 2
    cfg.DECODER.num_instance = 16
    cfg.DECODER.triangulation_method = "jacobi"
    cfg.DECODER.dropout = 0.0
    cfg.POSE_RESNET.NUM_DECONV_FILTERS = [32, 32, 32]
    cfg.DATASET.CAMERA_NUM = 3
    cfg.MULTI_PERSON.MAX_PEOPLE_NUM = 4
    cfg.PARALLEL.COMPUTE_DTYPE = "float32"
    return cfg


def check_train_step(card):
    """Phase 12: one training step of the toy config, kernels on the card
    against the plain path on the CPU, float32 with TF32 off: loss terms
    at rtol 1e-4, every gradient within 1e-3 of its leaf's largest."""
    from mvgformer_tpu_torch.core.train import (create_train_state,
                                                make_train_step)
    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.models.mvgformer import MVGFormer

    cfg = toy_train_cfg()
    runs = []
    for device in ("cuda", "cpu"):
        runs.append((MVGFormer(cfg, device=device,
                               generator=torch.Generator().manual_seed(SEED)),
                     make_batch(cfg, batch_size=1, seed=SEED, num_people=2,
                                device=device)))
    before = [fn.launches for fn in TRAIN_KERNELS]
    results = []
    for model, b in runs:
        state, tx = create_train_state(cfg, model)
        _, metrics = make_train_step(cfg, model, tx)(state, b)
        results.append((metrics, {k: p.grad for k, p in
                                  model.named_parameters()}))
    (m_gpu, g_gpu), (m_cpu, g_cpu) = results
    if [fn.launches for fn in TRAIN_KERNELS] == before:
        fail("the card's training step launched no training kernel")
    loss_err = max(abs(m_gpu[k].item() - m_cpu[k].item())
                   / max(abs(m_cpu[k].item()), 1e-6) for k in m_cpu)
    grad_err, worst = 0.0, None
    for k, g in g_cpu.items():
        if g is None:
            if g_gpu[k] is not None:
                fail(f"{k} has a gradient on the card only")
            continue
        rel = ((g_gpu[k].cpu() - g).abs().max()
               / max(g.abs().max().item(), 1e-12)).item()
        if rel > grad_err:
            grad_err, worst = rel, k
    ok = loss_err <= 1e-4 and grad_err <= 1e-3
    phase("train_step_card_vs_cpu", dtype="float32",
          loss_max_rel_err=loss_err, grad_max_rel_err=grad_err,
          worst_grad=worst, ok=ok, card=card)
    if not ok:
        fail("the card's training step disagrees with the CPU's")


def train(card):
    """Phase 13: the flagship training config through make_train_step.
    Every kernel count is set to 0 first; returns the counts after the
    run, the steps/s and the peak memory."""
    from mvgformer_tpu_torch.config import load_config
    from mvgformer_tpu_torch.core.train import (create_train_state,
                                                make_train_step)
    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.models.mvgformer import MVGFormer

    cfg = load_config(str(REPO / "configs" / "panoptic"
                          / "knn5-lr4-q1024.yaml"))
    cfg.DECODER.triangulation_method = "jacobi"
    cfg.PARALLEL.COMPUTE_DTYPE = "bfloat16"
    layers = cfg.DECODER.num_decoder_layers
    model = MVGFormer(cfg, generator=torch.Generator().manual_seed(SEED))
    batches = [make_batch(cfg, batch_size=1, seed=SEED + 100 + i,
                          num_people=3, cam_seed=SEED)
               for i in range(TRAIN_STEPS)]
    state, tx = create_train_state(cfg, model)
    step = make_train_step(cfg, model, tx)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    backbone = {k: v.clone() for k, v in model.state_dict().items()
                if k.startswith("backbone.")}
    # launches per step: per layer and level one table build and one
    # gather-reduce forward in the forward and again in the remat
    # recompute, one gather-reduce backward; nothing else
    L = len(SPATIAL_SHAPES)
    remat = 2 if cfg.PARALLEL.REMAT_DECODER else 1
    want_per_step = {table_build.build_corner_table: remat * L * layers,
                     table_gather.gather_reduce_forward: remat * L * layers,
                     table_gather.gather_reduce_backward: L * layers}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in ALL_KERNELS:
        fn.launches = 0
    times = []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        bad = [k for k, v in metrics.items() if not torch.isfinite(v)]
        if bad:
            fail(f"non-finite {bad} in training step {i}")
        for fn in ALL_KERNELS:
            want = want_per_step.get(fn, 0) * (i + 1)
            if fn.launches != want:
                fail(f"{fn.launches} launches of {fn.__name__} after "
                     f"{i + 1} steps, expected {want}")
    launches = {fn.__name__: fn.launches for fn in ALL_KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    in_step, captured = profile_b3(step, state, batches[:2], gen, L)
    sd = model.state_dict()
    if not all(torch.equal(v, sd[k]) for k, v in backbone.items()):
        fail("the frozen backbone changed")
    grads = {}
    for i in range(layers):
        for lin in ("sampling_offsets", "attention_weights", "output_proj"):
            g = model.decoder.layers[i].proj_attn.get_submodule(lin).weight.grad
            grads[f"layer{i}.{lin}"] = (float("nan") if g is None
                                        else g.abs().max().item())
    dead = [k for k, v in grads.items() if not (math.isfinite(v) and v > 0)]
    if dead:
        fail(f"no finite non-zero gradient reached {dead}")
    steady = times[TRAIN_WARMUP:]
    phase("train", steps=len(times), batch=1, dtype="bfloat16",
          solver="jacobi", remat=cfg.PARALLEL.REMAT_DECODER,
          dropout=cfg.DECODER.dropout, steps_per_s=len(steady) / sum(steady),
          first_step_s=times[0], step_s=times,
          peak_mem_gib=peak, losses={k: v.item() for k, v in metrics.items()},
          sampler_grad_max_abs=grads, kernel_launches=launches,
          launches_per_step={fn.__name__: n for fn, n in
                             want_per_step.items()},
          b3_in_step=in_step, card=card)
    return launches, captured, in_step


@contextlib.contextmanager
def capture_gather_operands(into, levels):
    """While active, record the (tables, idx, w4) of the first `levels`
    gather-reduce calls of the corner sampler (the first decoder layer's
    levels) into `into` and call through, so no launch count changes.
    `into` None records nothing."""
    original = sampling.deform_gather_reduce

    def recorder(tables, idx, w4):
        if into is not None and len(into) < levels:
            into.append((tables.detach(), idx, w4.detach()))
        return original(tables, idx, w4)

    sampling.deform_gather_reduce = recorder
    try:
        yield
    finally:
        sampling.deform_gather_reduce = original


B3_KERNELS = {"gather_reduce_fwd_kernel": "fwd",
              "segment_sum_kernel": "bwd", "rows_kernel": "bwd_rows"}


def profile_b3(step, state, batches, gen, levels):
    """torch.profiler over the given training steps, after the timed ones
    (so their peak memory holds no captured operand): the device ms per
    launch of B3's kernels (the backward's two kernels summed per launch)
    and of the sort kernels, by name; and the first decoder layer's B3
    operands of the first of these steps."""
    from torch.profiler import ProfilerActivity, profile

    captured = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i, batch in enumerate(batches):
            with capture_gather_operands(captured if i == 0 else None,
                                         levels):
                state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
    total = {"fwd": 0.0, "bwd": 0.0, "bwd_rows": 0.0, "sort": 0.0}
    count = {"fwd": 0, "bwd": 0, "bwd_rows": 0, "sort": 0}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        kind = next((v for k, v in B3_KERNELS.items() if k in e.key), None)
        if kind is None and "sort" in e.key.lower() and us > 0:
            kind = "sort"
        if kind is not None:
            total[kind] += us / 1e3
            count[kind] += e.count
    if count["fwd"] == 0 or count["bwd"] == 0:
        fail(f"the profiler saw no B3 kernel in the step: {count}")
    return {"steps": len(batches),
            "fwd_ms_per_launch": total["fwd"] / count["fwd"],
            "bwd_ms_per_launch": (total["bwd"] + total["bwd_rows"])
            / count["bwd"],
            "fwd_launches": count["fwd"], "bwd_launches": count["bwd"],
            "sort_kernels_ms_per_step": total["sort"] / len(batches)
            }, captured


def check_step_operands(card, captured):
    """Phase 13b: B3 on the flagship training step's own operands (the
    first decoder layer's three levels, captured in phase 13, a random
    cotangent): forward and backward against the plain versions, the
    backward twice bit for bit, untouched rows 0; the samples per row of
    each level; and times as in phase 10."""
    if len(captured) != len(SPATIAL_SHAPES):
        fail(f"captured {len(captured)} gather-reduce calls in the step")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    tables = [t for t, _, _ in captured]
    samples = [(i, w) for _, i, w in captured]
    cts = [torch.randn(i.shape + (t.shape[-1] // 4,), device="cuda",
                       generator=gen).to(t.dtype)
           for t, (i, _) in zip(tables, samples)]
    ok, same, levels = True, True, []
    for tbl, (idx, w4), ct in zip(tables, samples, cts):
        level_ok, errs, level_same = check_gather_level(tbl, idx, w4, ct)
        ok &= level_ok
        same &= level_same
        levels.append({"rows": tbl.shape[1], **row_load(tbl, idx),
                       "fwd_max_abs_err": errs[
                           table_gather.gather_reduce_forward],
                       "bwd_max_err_per_max_grad": errs["bwd_rel"]})
    fwd, bwd = (table_gather.gather_reduce_forward,
                table_gather.gather_reduce_backward)
    times = {
        "fwd_ms": sum(cuda_ms(lambda a=a: fwd(*a))
                      for a in zip(tables, *zip(*samples))),
        "bwd_ms": sum(cuda_ms(lambda a=a: bwd(*a))
                      for a in zip(tables, *zip(*samples), cts)),
        **backward_parts(tables, samples, cts)}
    work = {
        "fwd_bound_ms": bounds.total([bounds.table_gather_forward(t, i)
                                      for t, (i, _) in zip(tables, samples)
                                      ]).bound_ms,
        "bwd_bound_ms": bounds.total([bounds.table_gather_backward(t, i)
                                      for t, (i, _) in zip(tables, samples)
                                      ]).bound_ms}
    phase("table_gather_step_operands", dtype=str(tables[0].dtype),
          NH=tables[0].shape[0], S=samples[0][0].shape[1], levels=levels,
          chunk=table_gather.CHUNK, ok=ok, bwd_bit_identical=same, **times,
          **work, card=card)
    if not (ok and same):
        fail("B3 disagrees with its plain versions, or between two "
             "launches, on the training step's operands")
    return {"ms": times["fwd_ms"], "bwd_ms": times["bwd_ms"],
            "sort_ms": times["sort_ms"],
            "kernel_only_ms": times["bwd_kernel_only_ms"]}


def row_load(tbl, idx):
    """Samples per table row of one level: the largest, the 99th percentile
    over the rows that any sample touches, the share of touched rows, and
    the share of samples in rows over the backward's tile of CHUNK."""
    NH, R, _ = tbl.shape
    k = idx.long()
    on = (k >= 0) & (k < R)
    rows = (torch.arange(NH, device=idx.device)[:, None] * R + k)[on]
    per_row = torch.bincount(rows, minlength=NH * R)
    hit = per_row[per_row > 0].float()
    over = per_row > table_gather.CHUNK
    return {"samples_per_row_max": int(per_row.max()),
            "samples_per_row_p99": float(torch.quantile(
                hit[:2 ** 24], 0.99)),
            "rows_touched_share": hit.numel() / (NH * R),
            "share_in_rows_over_chunk": float(per_row[over].sum()
                                              / max(int(on.sum()), 1))}


def probe_cases(dtype, rng):
    """The probe kernels' cases at the probes' shapes (tools/probes/) and at
    B3's flagship level-0 row, in one dtype: (kernel, label, args, kwargs,
    timed); a timed case (bfloat16 only) is timed into its kernel's row of
    the kernels line."""
    def table(*shape):
        a = rng.random(shape, dtype=np.float32) - np.float32(0.5)
        return torch.from_numpy(a).to("cuda", dtype)

    def ints(high, *shape):
        return torch.from_numpy(rng.integers(0, high, shape,
                                             dtype=np.int32)).to("cuda")

    bf16 = dtype == torch.bfloat16
    rg, wg, ta, sc, ts = (gather_forms.row_gather, gather_forms.window_gather,
                          gather_forms.take_along, gather_forms.scale,
                          gather_forms.table_slots)
    small, big = table(2048, 128), table(31488, 128)
    idx = ints(2048, 30720)
    p7 = (table(40, 31460, 128), ints((31460 - 1024) // 8, 40, 120),
          ints(1024, 40, 61440))
    cases = [
        (rg, "P1/P2/P5 2048 rows S 30720", (small, idx), {}, False),
        (rg, "P1 31488 rows S 30720", (big, ints(31488, 30720)), {}, False),
        (rg, "P6 f2/f3 and f6", (small, idx[:512].contiguous()), {}, False),
        (rg, "P8 one pair R 41620 S 184320",
         (table(41620, 128), ints(41620, 184320)), {}, False),
        (rg, "B3 flagship level 0: 40 x 33280 rows, S 122880",
         (table(40, 33280, 128), ints(33280, 40, 122880)), {}, bf16),
        (wg, "P7 select: 40 x 31460 rows, 120 x 512, W 1024", p7,
         dict(W=1024, unit=8), bf16),
        (wg, "P7 copy", p7, dict(W=1024, unit=8, mode="copy"), False),
        (wg, "P7 zero", (table(4, 3000, 128), ints(200, 4, 120),
                         ints(1024, 4, 61440)),
         dict(W=1024, unit=8, mode="zero"), False),
        (wg, "P8 select, escapes clamped, unit 1",
         (table(1, 41620, 128), ints(41620 - 512, 1, 180),
          ints(512, 1, 184320)), dict(W=512, unit=1), False),
        (ta, "P4 take_eq (2048, 128) x (30720, 128)",
         (small, idx[:, None].expand(30720, 128).contiguous(), 0), {}, bf16),
        (ta, "P6 f1", (small, ints(2048, 512, 128), 0), {}, False),
        (ta, "P6 f4", (table(8, 128), ints(8, 8, 128), 0), {}, False),
        (ta, "P6 f5 axis 1", (table(128, 128), ints(128, 128, 128), 1), {},
         False),
        (sc, "P3 (2048, 128), a = 2", (small, 2.0), {}, bf16),
    ]
    if not bf16:
        cases.append((sc, "a = 0.3", (small, 0.3), {}, False))
    v_small, v_big = table(40, 16, 30, 32), table(40, 128, 240, 32)
    for name, slots in gather_forms.SLOT_MAPS.items():
        cases.append((ts, f"P11 {name} at (16, 30)", (v_small, slots), {},
                      bf16))
        cases.append((ts, f"{name} at (128, 240)", (v_big, slots), {}, False))
    return cases


PROBE_PLAIN = {gather_forms.row_gather: gather_forms.row_gather_plain,
               gather_forms.window_gather: gather_forms.window_gather_plain,
               gather_forms.take_along: gather_forms.take_along_plain,
               gather_forms.scale: gather_forms.scale_plain,
               gather_forms.table_slots: gather_forms.table_slots_plain}


def probe_library_call(kernel, args, kwargs):
    """The one PyTorch call of each probe kernel's function, on operands
    built here, before any clock (None for the table slots)."""
    if kernel is gather_forms.row_gather:
        tbl, idx = args
        if tbl.dim() == 2:
            return lambda: torch.index_select(tbl, 0, idx)
        flat, rows = flat_rows(tbl, idx)
        return lambda: torch.index_select(flat, 0, rows)
    if kernel is gather_forms.window_gather:
        tbl, base, local = args
        if kwargs.get("mode", "select") != "select":
            return None
        flat, rows = flat_rows(tbl, gather_forms.window_rows(
            base, local, **kwargs)[0])
        return lambda: torch.index_select(flat, 0, rows)
    if kernel is gather_forms.take_along:
        tbl, idx, axis = args
        idx64 = idx.long()
        return lambda: torch.gather(tbl, axis, idx64)
    if kernel is gather_forms.scale:
        x, a = args
        return lambda: torch.mul(x, a)
    return None


def probe_work(kernel, args, kwargs) -> bounds.Work:
    if kernel is gather_forms.row_gather:
        return bounds.row_gather(*args)
    if kernel is gather_forms.window_gather:
        return bounds.window_gather(*args, kwargs["W"], kwargs["unit"],
                                    kwargs.get("mode", "select"))
    if kernel is gather_forms.take_along:
        return bounds.take_along(*args)
    if kernel is gather_forms.scale:
        return bounds.scale(args[0].numel(), args[0].element_size())
    NH, h, w, D = args[0].shape
    return bounds.table_build(NH, h, w, D, args[0].element_size())


def check_probe_kernels(card):
    """Phase 14: each probe kernel against its plain version on the card,
    float32 and bfloat16, at the probes' shapes and B3's flagship level-0
    row: bit for bit (scale: exact, and equal to x * 2 at a = 2); the
    bfloat16 case of each kernel's table row timed beside its plain
    version and its library call, with its bound from the same inputs.
    Returns the table rows by kernel."""
    rng = np.random.default_rng(SEED)
    stats = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                 "library_ms": None, "work": bounds.Work(0), "at": []}
             for k in gather_forms.KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        lines = []
        for kernel, label, args, kwargs, timed in probe_cases(dtype, rng):
            got = kernel(*args, **kwargs)
            torch.cuda.synchronize()
            want = PROBE_PLAIN[kernel](*args, **kwargs)
            equal = torch.equal(got, want)
            if kernel is gather_forms.scale and args[1] == 2.0:
                equal &= torch.equal(got, args[0] * 2)
            err = (got.float() - want.float()).abs().max().item()
            del got, want
            st = stats[kernel]
            st["max_abs_err"] = max(st["max_abs_err"], err)
            line = {"kernel": kernel.__name__, "case": label,
                    "bitwise_equal": bool(equal)}
            if timed:
                library = probe_library_call(kernel, args, kwargs)
                work = probe_work(kernel, args, kwargs)
                dev_ms, host_us = device_ms(lambda: kernel(*args, **kwargs))
                line.update(
                    ms=cuda_ms(lambda: kernel(*args, **kwargs)),
                    device_ms=dev_ms, host_us=host_us,
                    plain_ms=cuda_ms(lambda: PROBE_PLAIN[kernel](
                        *args, **kwargs), runs=5, warmup=1),
                    library_ms=None if library is None else cuda_ms(library),
                    bound_ms=work.bound_ms)
                if library is not None:
                    line["library_device_ms"], line["library_host_us"] = \
                        device_ms(library)
                for key in ("device_ms", "host_us", "library_device_ms",
                            "library_host_us"):
                    if key in line:
                        st[key] = st.get(key, 0.0) + line[key]
                st["ms"] += line["ms"]
                st["plain_ms"] += line["plain_ms"]
                if library is not None:
                    st["library_ms"] = (st["library_ms"] or 0.0) + line[
                        "library_ms"]
                st["work"] = st["work"] + work
                st["at"].append(label)
            lines.append(line)
            if not equal:
                fail(f"{kernel.__name__} differs from its plain version: "
                     f"{label} {dtype} (max abs err {err})")
        phase("probe_kernels_vs_plain", dtype=str(dtype), cases=len(lines),
              bitwise_equal=all(c["bitwise_equal"] for c in lines),
              timed=[c for c in lines if "ms" in c], card=card)
        torch.cuda.empty_cache()
    return stats


def run_probes(card):
    """Phase 15: each ported probe's main once on the card at reduced
    repetitions, its printed results into build/probes.jsonl. The
    probe kernels' counts are set to 0 first and read after: the probes
    are the path that runs these kernels. Returns the counts."""
    out_dir = REPO / "build"
    out_dir.mkdir(exist_ok=True)
    for fn in gather_forms.KERNELS:
        fn.launches = 0
    results, seconds = {}, {}
    with open(out_dir / "probes.jsonl", "w") as log:
        for name in PROBES:
            main_fn = importlib.import_module(
                f"mvgformer_tpu_torch.tools.probes.{name}").main
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                results[name] = main_fn(list(PROBE_RUNS))
            seconds[name] = time.perf_counter() - t0
            torch.cuda.empty_cache()
    launches = {fn.__name__: fn.launches for fn in gather_forms.KERNELS}
    by_name = {r["variant"]: r for rs in results.values() for r in rs}
    keep = ("ms", "library_ms", "plain_ms", "ns_per_row", "p50", "p95",
            "max", "escaped_clamped")
    phase("probes", runs=PROBE_RUNS, seconds=seconds,
          results_per_probe={k: len(v) for k, v in results.items()},
          kernel_launches=launches, selected={
              v: {k: by_name[v][k] for k in keep if k in by_name[v]}
              for v in ("flagship_bf16", "window_select", "composition",
                        "sort_key_val", "sorted_block_span_BS512",
                        "sorted_block_span_BS1024",
                        "sorted_block_span_BS2048", "window_BS1024_W512_1pair",
                        "gather_40pairs_sorted", "gather_40pairs_unsorted")},
          card=card)
    return launches


@contextlib.contextmanager
def kept_signal_handlers():
    """The train CLI's PreemptionGuard installs SIGTERM and SIGINT
    handlers; put this process's back afterwards."""
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        yield
    finally:
        for sig, handler in saved.items():
            signal.signal(sig, handler)


def cli_log(out_dir, cfg_path, phase_name):
    """The text of the CLI's log files for `cfg_path` under `out_dir`."""
    stem = Path(cfg_path).stem
    logs = sorted(Path(out_dir).glob(f"*/{stem}/*_{phase_name}.log"))
    if not logs:
        fail(f"no {phase_name} log of {stem} under {out_dir}")
    return "".join(p.read_text() for p in logs)


def count_kernels():
    """Every kernel count of the serving and training paths set to 0."""
    for fn in ALL_KERNELS:
        fn.launches = 0


def cli_train(card, out_dir):
    """Phase 16 (cli_train): the port's train CLI,
    `mvgformer_tpu_torch.run.train.main`, on
    configs/synthetic_ap_ablation.yaml at its full width (q 1024, 4
    layers, 5 views at 480x256, d_model 128, 8 heads x 8 points x 3
    levels, bf16, TRAIN_BACKBONE, TRI_GRAD_CLIP, SKIP_NONFINITE, Jacobi,
    clamp_refs_to_space; dropout 0.1 and remat by default) with
    CLI_TRAIN_ARGS (3 steps; 8 frames, cut for time) in a temporary
    OUTPUT_DIR. Every kernel count is set to 0 first. Checks each step's
    losses finite, B2 / B3 forward / B3 backward at 24 / 24 / 12 launches
    per step, B1 once per layer per eval batch and nothing else, `eval
    epoch 0` and its metrics in the log, and the checkpoint read back
    with weights_only=True. Returns the CLI's result, the counts and the
    config."""
    from mvgformer_tpu_torch.config import load_config
    from mvgformer_tpu_torch.run import train as train_cli

    args = ["--cfg", str(ABLATION_CFG), *CLI_TRAIN_ARGS,
            f"OUTPUT_DIR={out_dir}"]
    cfg = load_config(str(ABLATION_CFG), [a for a in args if "=" in a])
    layers, L = cfg.DECODER.num_decoder_layers, len(SPATIAL_SHAPES)
    remat = 2 if cfg.PARALLEL.REMAT_DECODER else 1
    eval_batches = math.ceil(cfg.DATASET.MAX_DATA_NUM / cfg.TEST.BATCH_SIZE)
    per_step = {table_build.build_corner_table: remat * L * layers,
                table_gather.gather_reduce_forward: remat * L * layers,
                table_gather.gather_reduce_backward: L * layers}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    count_kernels()
    t0 = time.perf_counter()
    with kept_signal_handlers():
        result = train_cli.main(args)
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in ALL_KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = result["steps"]
    if steps != 3:
        fail(f"the train CLI took {steps} steps, expected 3")
    bad = [(i, k) for i, losses in enumerate(result["step_losses"])
           for k, v in losses.items() if not math.isfinite(v)]
    if bad:
        fail(f"non-finite losses in the train CLI's steps: {bad}")
    want = {fn: n * steps for fn, n in per_step.items()}
    want[deform_attn.deform_sample] = layers * eval_batches
    for fn in ALL_KERNELS:
        if fn.launches != want.get(fn, 0):
            fail(f"{fn.launches} launches of {fn.__name__} in the train "
                 f"CLI, expected {want.get(fn, 0)}")
    log = cli_log(out_dir, ABLATION_CFG, "train")
    if "eval epoch 0 thr" not in log or "mpjpe" not in log:
        fail("the train CLI logged no eval of epoch 0 with its metrics")
    ckpt = Path(result["ckpt_dir"]) / "0.pt"
    payload = torch.load(ckpt, weights_only=True)
    if payload["step"] != steps or set(payload) != {
            "model", "opt_state", "step", "meta"}:
        fail(f"the checkpoint {ckpt} does not hold the trained state")
    step_s = result["step_s"]
    ev = result["evals"][0]
    phase("cli_train", cli="mvgformer_tpu_torch.run.train",
          cfg=str(ABLATION_CFG.relative_to(REPO)), args=list(CLI_TRAIN_ARGS),
          steps=steps, step_s=step_s,
          steps_per_s=(steps - 1) / sum(step_s[1:]),
          steps_per_s_with_first=steps / sum(step_s),
          train_loop_s=result["train_loop_s"],
          prefetch_wait_s=result["train_wait_s"],
          prefetch_wait_share=result["train_wait_s"]
          / result["train_loop_s"],
          peak_mem_gib=peak, last_losses=result["step_losses"][-1],
          eval_frames=ev["frames"], eval_loop_s=ev["loop_s"],
          eval_metrics=ev["metrics"], kernel_launches=launches,
          launches_per_step={fn.__name__: n for fn, n in per_step.items()},
          checkpoint=str(ckpt.relative_to(out_dir)), seconds=seconds,
          card=card)
    return result, launches, cfg


def check_placed_batches(card, dataset):
    """Phase 17c: the Prefetcher's placed batches (DevicePlacer: pinned
    memory, non_blocking copies on its own stream) against synchronous
    .to("cuda") copies of the same CPU batches, bit for bit, with the
    consumer's stream kept busy while the copies run."""
    from mvgformer_tpu_torch.data.meta import map_tensors
    from mvgformer_tpu_torch.data.prefetch import DevicePlacer

    t0 = time.perf_counter()
    host = list(dataset.batches(2, shuffle=False, drop_last=False))
    compared = 0
    for idx, placed in DevicePlacer("cuda").prefetch(iter(host)):
        busy = torch.randn(4096, 4096, device="cuda")
        for _ in range(10):
            busy = busy @ busy / 4096.0
        want = host[[i for i, _ in host].index(idx)][1].to("cuda")
        got_t, want_t = [], []
        map_tensors(placed, got_t.append)
        map_tensors(want, want_t.append)
        if len(got_t) != len(want_t) or not all(
                g.device == w.device and torch.equal(g, w)
                for g, w in zip(got_t, want_t)):
            fail(f"the Prefetcher's batch {idx} differs from a synchronous "
                 f"copy")
        compared += len(got_t)
    phase("cli_prefetch_vs_sync_copy", batches=len(host), tensors=compared,
          bytes=sum(t.numel() * t.element_size() for _, b in host
                    for t in [b.views]),
          seconds=time.perf_counter() - t0, card=card)


def cli_validate(card, ckpt_dir, out_dir):
    """Phase 17 (cli_validate): the port's validate CLI,
    `mvgformer_tpu_torch.run.validate.main`, (a) on
    configs/synthetic_ap_ablation.yaml with the cli_train checkpoint and
    --save_preds, whose first frame's preds must equal, bit for bit,
    core.infer.make_eval_step run here on the weights load_params_checkpoint
    returns, on the CLI's first batch; (b) on
    configs/panoptic/knn5-lr4-q1024.yaml at its full width with random
    weights (TRAIN.SEED) and FLAGSHIP_VALIDATE (synthetic frames, 8 of
    them, top-64, point-top-4, Jacobi, bf16), once through the gather and
    once with the windowed layer 1 through 'pallas_dma' (layer1_offset_clamp
    unset, as the serve_windowed phase): frames/s of the CLI's loop, the
    Prefetcher's wait share, B1 / B5 launches per frame and the escaped
    mass; (c) `check_placed_batches`. Each run sets every kernel count to
    0 first. Returns the counts of each run."""
    from mvgformer_tpu_torch.config import load_config
    from mvgformer_tpu_torch.core.infer import make_eval_step
    from mvgformer_tpu_torch.data.datasets import get_dataset
    from mvgformer_tpu_torch.models.mvgformer import MVGFormer
    from mvgformer_tpu_torch.run import validate as validate_cli
    from mvgformer_tpu_torch.utils.checkpoint import load_params_checkpoint

    runs = {}
    # (a) the checkpoint through the CLI and through make_eval_step
    preds_file = Path(out_dir) / "preds.npy"
    overrides = ["DATASET.MAX_DATA_NUM=8", f"OUTPUT_DIR={out_dir}"]
    count_kernels()
    t0 = time.perf_counter()
    res = validate_cli.main(["--cfg", str(ABLATION_CFG), "--model_path",
                             str(ckpt_dir), "--save_preds", str(preds_file),
                             *overrides])
    seconds = time.perf_counter() - t0
    runs["checkpoint"] = {fn.__name__: fn.launches for fn in ALL_KERNELS}
    cfg = load_config(str(ABLATION_CFG), overrides)
    thr = cfg.DECODER.inference_conf_thr[0]
    saved = np.load(Path(out_dir) / f"preds-{thr}.npy")
    model = MVGFormer(cfg, generator=torch.Generator().manual_seed(
        cfg.TRAIN.SEED))
    model.load_state_dict(load_params_checkpoint(str(ckpt_dir))[0])
    dataset = get_dataset(cfg, cfg.DATASET.TEST_SUBSET, is_train=False)
    first = dataset.load_batch(list(range(cfg.TEST.BATCH_SIZE))).to("cuda")
    pred = make_eval_step(cfg, model, thr)(first)[0].float().cpu().numpy()
    equal = bool(np.array_equal(pred, saved[0]))
    phase("cli_validate", run="checkpoint",
          cli="mvgformer_tpu_torch.run.validate",
          cfg=str(ABLATION_CFG.relative_to(REPO)), frames=len(saved),
          first_frame_bit_equal_to_make_eval_step=equal,
          max_abs_diff=float(np.abs(pred - saved[0]).max()),
          metrics=res[thr]["metrics"], kernel_launches=runs["checkpoint"],
          seconds=seconds, card=card)
    if not equal:
        fail("the validate CLI's first frame differs from make_eval_step "
             "on the checkpoint's weights")
    del model, first
    torch.cuda.empty_cache()

    # (b) the flagship width, through the gather and windowed
    fcfg = load_config(str(FLAGSHIP_CFG), list(FLAGSHIP_VALIDATE))
    layers, L = fcfg.DECODER.num_decoder_layers, len(SPATIAL_SHAPES)
    batches = math.ceil(fcfg.DATASET.MAX_DATA_NUM / fcfg.TEST.BATCH_SIZE)
    for impl, extra in ((None, ()), ("pallas_dma", WINDOWED_VALIDATE)):
        name = impl or "gather"
        count_kernels()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = validate_cli.main(["--cfg", str(FLAGSHIP_CFG),
                                 *FLAGSHIP_VALIDATE, *extra,
                                 f"OUTPUT_DIR={out_dir}"])
        seconds = time.perf_counter() - t0
        runs[name] = {fn.__name__: fn.launches for fn in ALL_KERNELS}
        loop = res[thr]["loop"]
        want = {deform_attn.deform_sample: (layers - (impl is not None))
                * batches}
        if impl is not None:
            want[IMPL_KERNEL[impl]] = L * batches
        for fn in ALL_KERNELS:
            if fn.launches != want.get(fn, 0):
                fail(f"{fn.launches} launches of {fn.__name__} in the "
                     f"validate CLI ({name}), expected {want.get(fn, 0)}")
        frames = loop["frames"]
        escaped = loop["escaped_mass"]
        phase("cli_validate", run=name, cli="mvgformer_tpu_torch.run.validate",
              cfg=str(FLAGSHIP_CFG.relative_to(REPO)),
              args=list(FLAGSHIP_VALIDATE) + list(extra), frames=frames,
              batch=fcfg.TEST.BATCH_SIZE, loop_s=loop["loop_s"],
              frames_per_s=frames / loop["loop_s"],
              prefetch_wait_s=loop["wait_s"],
              prefetch_wait_share=loop["wait_s"] / loop["loop_s"],
              launches_per_frame={fn.__name__: fn.launches / frames
                                  for fn in want},
              escaped_mass=escaped,
              escaped_mass_per_frame=(None if escaped is None
                                      else escaped / frames),
              metrics=res[thr]["metrics"],
              peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
              kernel_launches=runs[name], seconds=seconds, card=card)
        if escaped is not None and not escaped / frames < 1e-5:
            fail(f"escaped mass {escaped / frames} per frame at init with "
                 f"the unclamped plan")
        torch.cuda.empty_cache()

    # (c) the Prefetcher's copies
    check_placed_batches(card, get_dataset(fcfg, fcfg.DATASET.TEST_SUBSET,
                                           is_train=False))
    return runs


def parent_vs_change(card, parent):
    """B1 at B1_SHAPES, B4 and B5 on the K = 28 plan and B2 on the flagship
    value's level views, bfloat16, timed by this checkout's
    tools/launch_cost.py (--kernels PARENT_KERNELS) on the package of the
    checkout at `parent` and on this one in turns: parent, change, change,
    parent, one process each, on the same inputs. Returns, per case,
    {parent_ms, parent_device_ms, change_ms, change_device_ms}: each the
    tree's two turns."""
    tool = REPO / "mvgformer_tpu_torch" / "tools" / "launch_cost.py"
    turns = {}
    for label, root in (("parent", parent), ("change", REPO),
                        ("change", REPO), ("parent", parent)):
        proc = subprocess.run(
            [sys.executable, str(tool), "--root", str(root), "--label",
             label, "--kernels", PARENT_KERNELS],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            fail(f"launch_cost on the {label} tree failed:\n"
                 f"{proc.stdout}{proc.stderr}")
        for line in proc.stdout.splitlines():
            r = json.loads(line)
            t = turns.setdefault(r["case"], {})
            for key in ("ms", "device_ms"):
                t.setdefault(f"{label}_{key}", []).append(r[key])
    phase("parent_vs_change", parent=str(parent), order=[
        "parent", "change", "change", "parent"], cases=turns, card=card)
    return turns


def parent_turns(turns, kernel):
    """The parent_vs_change times of the one case that times `kernel`, or
    nothing without --parent."""
    return next((t for case, t in turns.items()
                 if case.startswith(kernel.__name__)), {})


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", default=None,
                        help="an unpacked parent checkout: time its B1, B2, "
                        "B4 and B5 beside this tree's "
                        "(tools/launch_cost.py)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one GPU")
    card = card_line()
    phase("card", nvidia_smi=card, torch=torch.__version__,
          cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))
    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.device import strict_float32
    from mvgformer_tpu_torch.models.mvgformer import MVGFormer

    strict_float32()
    t0 = time.perf_counter()
    built = _build.build_all([_build.CSRC / src for src in SOURCES])
    # ptxas's registers, stack and spill bytes per kernel instance
    reports = {src: _build.kernel_report(_build.CSRC / src)
               for src in SOURCES}
    phase("build", seconds=time.perf_counter() - t0, kernels=[
        {"source": src, "seconds": sec, "library": str(lib),
         "ptxas": reports[src]}
        for src, (lib, sec) in zip(SOURCES, built)])

    worst_f32, b1_shapes = check_kernel(card)
    window_stats = check_window_kernels(card)
    check_windowed_slice(card, *check_slice(card))

    cfg = flagship_cfg("bfloat16")
    model = MVGFormer(cfg, generator=torch.Generator().manual_seed(SEED))
    n = max(SERVE_FRAMES, WINDOW_FRAMES)
    frames = [make_batch(cfg, batch_size=1, seed=SEED + 1 + i,
                         num_people=3, cam_seed=SEED) for i in range(n)]
    launches = {"deform_sample": serve(card, cfg, model,
                                       frames[:SERVE_FRAMES])["deform_sample"]}
    for impl, kernel in IMPL_KERNEL.items():
        counts = serve(card, cfg, model, frames[:WINDOW_FRAMES], impl)
        launches[kernel.__name__] = counts[kernel.__name__]
    for name, count in launches.items():
        if count == 0:
            fail(f"the serving path never launched {name}")
    del model, frames
    torch.cuda.empty_cache()

    build_ms, build_device_ms, build_plain_ms, build_work = \
        check_table_build(card)
    gather_stats = check_table_gather(card)
    check_corner_sampler(card)
    check_train_step(card)
    train_launches, captured, in_step = train(card)
    for fn in TRAIN_KERNELS:
        if train_launches[fn.__name__] == 0:
            fail(f"the training path never launched {fn.__name__}")
    step_stats = check_step_operands(card, captured)
    del captured
    torch.cuda.empty_cache()
    probe_stats = check_probe_kernels(card)
    probe_launches = run_probes(card)
    for name, count in probe_launches.items():
        if count == 0:
            fail(f"the probes never launched {name}")

    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="cli-", dir=REPO / "build") \
            as out_dir:
        t_cli = time.perf_counter()
        train_result, cli_train_launches, _ = cli_train(card, out_dir)
        cli_runs = cli_validate(card, train_result["ckpt_dir"], out_dir)
        cli_runs["train"] = cli_train_launches
        phase("cli", seconds=time.perf_counter() - t_cli, card=card)
    for name in ("deform_sample", "build_corner_table",
                 "gather_reduce_forward", "gather_reduce_backward",
                 "window_block_dma"):
        if not any(run[name] for run in cli_runs.values()):
            fail(f"the CLIs never launched {name}")
    torch.cuda.empty_cache()

    turns = (parent_vs_change(card, Path(args.parent).resolve())
             if args.parent else {})
    flagship = "bfloat16 NH=40 S=122880 D=32 per level, the 3 flagship " \
        "levels summed (one training layer)"
    # a served frame launches B1 once at dense layer 1 and once per
    # later layer at the top-64 shape
    layers = cfg.DECODER.num_decoder_layers
    b1_frames = launches["deform_sample"] // layers
    b1_launches = {15360: b1_frames, 960: launches["deform_sample"]
                   - b1_frames}
    by_shape = [{"at": f"bfloat16 N=5 Lq={Lq} H=8 D=32 L=3 P={P}",
                 "launches": b1_launches[Lq], "ms": b1_shapes[Lq]["ms"],
                 "device_ms": b1_shapes[Lq]["device_ms"],
                 "plain_ms": b1_shapes[Lq]["plain_ms"],
                 "bound_ms": b1_shapes[Lq]["work"].bound_ms,
                 **turns.get(f"deform_sample Lq {Lq} P {P}", {})}
                for Lq, P in B1_SHAPES]
    dense = b1_shapes[B1_SHAPES[0][0]]
    kernels = [
        kernel_row(deform_attn.deform_sample, "deform_sample.cu",
                   "mvgformer_tpu/ops/pallas_deform.py:32",
                   launches["deform_sample"], worst_f32, dense["ms"],
                   dense["plain_ms"], None, dense["work"],
                   "bfloat16 N=5 Lq=15360 H=8 D=32 L=3 P=4 (dense layer 1)",
                   by_shape=by_shape, device_ms=dense["device_ms"],
                   ptxas=reports["deform_sample.cu"])]
    for kernel, source, replaces in (
            (window_block.window_block_matmul, "window_block.cu",
             "mvgformer_tpu/ops/window_pallas.py:34"),
            (window_dma.window_block_dma, "window_dma.cu",
             "mvgformer_tpu/ops/window_dma.py:38")):
        st = window_stats[kernel]
        kernels.append(kernel_row(
            kernel, source, replaces, launches[kernel.__name__],
            st["max_abs_err"], st["ms"], st["plain_ms"], None, st["work"],
            "bfloat16 layer-1 plan of the flagship rig, K=28 H=8 D=32 P=4, "
            "summed over the 3 levels", timed_launches=3,
            device_ms=st["device_ms"], ptxas=reports[source],
            **parent_turns(turns, kernel)))
    kernels.append(kernel_row(
        table_build.build_corner_table, "table_build.cu",
        "mvgformer_tpu/ops/table_pallas.py:60",
        train_launches["build_corner_table"], 0.0, build_ms, build_plain_ms,
        None, build_work, "bfloat16 N=5 H=8 D=32, the 3 flagship levels "
        "summed (bit for bit against the plain version)", timed_launches=3,
        also=["tools/probes/probe_table_kernel_forms.py:39 (form_b), :86 "
              "(form_c), :151 (form_d d2), :226 (form_e)"],
        device_ms=build_device_ms, ptxas=reports["table_build.cu"],
        **parent_turns(turns, table_build.build_corner_table)))
    for fn, replaces, extra in (
            (table_gather.gather_reduce_forward,
             "mvgformer_tpu/ops/onehot_gather.py:59",
             {"kernel_only_ms": gather_stats[
                 table_gather.gather_reduce_forward]["ms"],
              "in_step_ms_per_launch": in_step["fwd_ms_per_launch"],
              "step_operands_ms": step_stats["ms"]}),
            (table_gather.gather_reduce_backward,
             "mvgformer_tpu/ops/onehot_gather.py:216",
             {"sort_ms": gather_stats[
                 table_gather.gather_reduce_backward]["sort_ms"],
              "kernel_only_ms": gather_stats[
                  table_gather.gather_reduce_backward]["kernel_only_ms"],
              "in_step_ms_per_launch": in_step["bwd_ms_per_launch"],
              "bit_identical": gather_stats[
                  table_gather.gather_reduce_backward]["bit_identical"],
              "step_operands_ms": step_stats["bwd_ms"],
              "step_operands_sort_ms": step_stats["sort_ms"],
              "step_operands_kernel_only_ms": step_stats[
                  "kernel_only_ms"]})):
        st = gather_stats[fn]
        kernels.append(kernel_row(
            fn, "table_gather.cu", replaces, train_launches[fn.__name__],
            st["max_abs_err"], st["ms"], st["plain_ms"], st["library_ms"],
            st["work"], flagship, timed_launches=3, library="F.embedding_bag",
            ms_f32=st["ms_f32"], library_ms_f32=st["library_ms_f32"],
            **extra))
    for fn, replaces, also, library in PROBE_ROWS:
        st = probe_stats[fn]
        kernels.append(kernel_row(
            fn, "gather_forms.cu", replaces, probe_launches[fn.__name__],
            st["max_abs_err"], st["ms"], st["plain_ms"], st["library_ms"],
            st["work"], "bfloat16; " + " + ".join(st["at"]),
            timed_launches=len(st["at"]), also=also, library=library,
            **{k: st[k] for k in ("device_ms", "host_us",
                                  "library_device_ms", "library_host_us")
               if k in st}))
    serving_training = {fn.__name__ for fn in ALL_KERNELS}
    for row in kernels:
        if row["name"] in serving_training:
            row["cli_launches"] = {run: counts[row["name"]]
                                   for run, counts in cli_runs.items()}
    phase("ranking", order=ranking(kernels), card=card)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
