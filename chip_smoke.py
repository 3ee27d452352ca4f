"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR] [--benches-only] [--dlt-only]
                          [--point-topm-only]

Runs from the root of a checkout, needs one CUDA card and nvcc (CUDA_HOME or
/usr/local/cuda), and builds the port's kernels from the checkout's sources
into build/kernels/. Phases, each printed on its own line; any failure
exits non-zero:

  1. find the card and print its name and power limit;
  2. build the eight sources at once (deformable sampling, the two window
     kernels, the corner-table build, the table gather-reduce forward and
     backward, the serving DLT, point-top-m and the probe kernels' gather
     forms), one
     nvcc each, and
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
     for bit, untouched gradient rows exactly 0; both timed (`ms`, and
     `device_ms` on the device alone), the backward also in its parts
     (the sort of its wrapper, the bare flattened and per-pair sorts,
     the kernels alone on sorted samples), and the peak
     memory of one layer's forward and backward through the kernels and
     through plain autograd;
 11. the corner sampler (B2 + B3) against the deformable-sampling kernel
     (B1), the same contract, float32;
 12. one training step of a toy config in float32 (TF32 off), kernels on
     the card against the plain path on the CPU: every loss term and every
     gradient;
 13. train: the flagship training config (bfloat16, batch 1, gt match,
     Jacobi DLT, remat, dropout 0.1), 2 warm-up and 3 timed steps through
     core.train.make_train_step on batches made before the clock starts;
     finite losses, the backbone unchanged, non-zero sampler gradients,
     the launch counts the design predicts, steps/s and peak memory; then
     torch.profiler over 2 more steps gives B3's device ms per launch, and
     the first of them records the first decoder layer's B3 operands (a
     wrapper around ops.sampling.deform_gather_reduce that calls through);
 13b. B2 and B3 on those captured operands of the training step: B2 on
     the step's level views bit for bit against its plain version and the
     tables B3 read; B3 against the plain versions as in phase 10, the
     samples per table row of each level (max, p99, share in rows over the
     backward's tile), and timed;
 14. the launch floor (an empty kernel, `gather_forms.noop`, timed as the
     kernels are); then the probe kernels (row gather, windowed gather,
     take-along, scale, and the table slots through B2's kernel) against
     their plain versions at the probes' shapes, at B3's flagship level-0
     row and, for scale and the table slots, at a flagship level-0 size
     where bytes set the time (5 x 128 x 240 x 256 and (40, 128, 240,
     32)), float32 and bfloat16, bit for bit (scale exact); the bfloat16
     cases of each timed shape beside their plain version and library
     call: `ms` one call between two events (host path and device
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
     `cli_launches`;
 18. mvp: configs/panoptic/knn5-lr4-q1024.yaml at its full width as the
     MvP baseline (TRANSFORMER=multi_view_pose_transformer, camera-ray
     ProjAttn, cat_proj fusion, query adaptation). 18a: one frame with 64
     queries through the kernels on the card against the plain path on the
     CPU, float32 with TF32 off, every layer at the golden classes. 18b:
     serve in bfloat16, batch 1, 1024 queries: B1 once per layer and frame
     at its L 3 / P 8 instance and nothing else, frames/s, latency, peak
     memory. 18c: train in bfloat16, 2 warm-up and 3 timed steps through
     make_train_step: finite losses, 12 / 12 / 12 B2 / B3 launches per
     step, non-zero sampler gradients, steps/s, peak memory. 18d:
     torch.profiler over 2 frames and over 2 steps: the device's idle
     share and its top ops;
 19. dq_options: the DQ model's options at the toy width, one frame and one
     training step each, card against CPU (attention_embed,
     init_self_attention, bayesian_update, share_layer_weights,
     triangulation 'st', init query_adapt_center); then the flagship
     training config at full width, one warm-up and one timed step each
     with TRAIN.SAMPLE_CHUNKS 8 and with REMAT_POLICY 'save_sampled'
     against neither (the port accepts both and runs its one path): the
     same first-step losses within bfloat16 2e-2, every gradient within
     2e-2 of its leaf's largest, the plain step's B2 / B3 launches per
     step, steps/s, peak memory.
     Each of these paths runs with the kernel counts set to 0 before it;
     the kernel rows carry the counts as `path_launches`.
 20. data parallelism (`mvgformer_tpu_torch.parallel`). 20a: the flagship
     training step (bf16, dropout 0) on 2 ranks that
     `parallel.spawn` starts on cuda:0 over gloo (the backend rule: ranks
     that share a card), one frame each, against one process taking the
     2-frame global batch: losses within bf16 2e-2 (float32: 1e-4),
     every reduced gradient within 2e-2 of its leaf's largest (bf16:
     `bf16_grad_bounds`, 2x the one process's own bf16 rounding of the
     leaf where that is larger), the ranks' parameters
     after the Adam step bit-equal; per rank steps/s over 3 steps, the
     gradient all-reduce's ms and share of a step (a Stopwatch around
     each), B2 / B3 launches per step (counts set to 0 before the 5
     steps; the rows' `path_launches`); where 2 or more cards are
     visible, the same on two cards over NCCL. 20b: the train CLI under
     `torchrun --standalone --nproc_per_node 2` on
     configs/synthetic_ap_ablation.yaml, 3 steps: one log, one checkpoint
     (step 3) that loads with weights_only=True, finite losses. 20c: the
     validate CLI under torchrun at the flagship width (8 synthetic
     frames, 4 per rank per batch) against the 1-rank CLI at batches of
     4: the gathered preds at the golden classes, frames/s of both;
 21. the debug dumps: whether matplotlib is there (decided first); the
     toy width's ProjAttn taps card vs CPU in float32 within 1e-4; with
     matplotlib the validate CLI with VISUALIZATION_JUMP_NUM 0 and
     DEBUG.DEBUG on 2 flagship frames, listing its files, else the
     flagship frame's taps and the epipolar pickle;
 22. a Stopwatch around the served flagship frame (bf16, top-64,
     point-top-4, Jacobi): the backbone, each decoder layer and the rest
     in ms, beside frames/s;
 23. view parallelism: B1 against its plain version at one view (N 1, Lq
     15360 and 960, P 4); then one flagship frame's 5 views over the 5
     ranks of a (1 x 5) grid that `parallel.spawn(..., views=5)` starts
     on cuda:0 over gloo (NCCL with a card per rank where 5 cards show),
     against one process on the whole frame. 23a serving (top-64,
     point-top-4, Jacobi) in float32 with TF32 off: top-K equal on every
     rank and, as a set, to one process (a near-tie at the K-th score
     allowed and printed), the last layer's logits and 3D at the golden
     classes over the queries both keep; in bf16 within BF16_SERVE_BOUND
     of their largest; per rank frames/s, the view collectives' ms and
     share of a frame, B1 launches (per Lq) and peak memory. 23b the same
     with the windowed layer 1 ('pallas_dma'), 23d the MvP baseline
     ('cat_proj'), both float32. A token whose projection lies on an
     image edge, inside in one run and outside in the other at a layer's
     input, is printed and left out (at most VP_MAX_FLIPS of them, each
     within VP_EDGE_PX of the edge in both runs). 23c one training step
     in float32 (losses rtol 1e-3, gradients 2e-2 of a leaf's largest)
     and bf16 (2e-2, `bf16_grad_bounds`), the ranks' parameters
     bit-equal; per rank steps/s, the collectives' share and 24 / 24 / 12
     B2 / B3 launches per step;
 24. tools: configs/synthetic_ap_ablation.yaml's widths (head dim 16, 8
     points, levels 64x120 / 32x60 / 16x30) and the tools of
     mvgformer_tpu_torch/tools/ that the root tools/ had. 24a: B1 (Lq
     15360 at P 8 and 4, 1920 and 960 at P 8, 960 at P 4), B2, B3 forward
     and backward (one dense training layer) and B4 / B5 (the rig's
     layer-1 plan under clamp 4, P 8 and 4) against their plain versions
     at those shapes, float32 and bfloat16, the tolerances of phases 3, 4,
     9 and 10, each launched twice for the same bits, the vector instances
     required, bfloat16 timed (`ablation_d16` in the kernel rows). 24b:
     ap_train_fast on 8 frames for 2 epochs (16 steps), every step under
     the sync debug mode: no synchronization after a run's first step;
     24 / 24 / 12 B2 / B3 launches per step; the epoch lines, steps/s,
     peak memory; then --resume to epoch 3, which starts at 2. 24c:
     ap_ablation's rows jacobi_dense, jacobi_k64_ptop4,
     jacobi_k128_clamp4_windowed and the same with 'pallas_dma' through
     the validate CLI on the card (8 frames), each with its frames/s and
     the CLI's kernel counts, then ap_spread_report on them. 24d:
     extract_bone_lengths. 24e: verify_checkpoint on a Panoptic tree the
     phase writes and a flagship checkpoint of random weights: the gate
     fails, non-zero. 24f: bench_host_pipeline at 8 frames and 1 and 2
     threads where cv2 imports, else a line saying it is absent.
 25. benches: `python -m mvgformer_tpu_torch.bench` (its main) at full
     width, which checks one float32 frame card against CPU (phase 5's
     `bench.card_vs_cpu`), times 5 loops of 20 chained bf16 frames, counts
     a frame's syncs, profiles 3 frames and must print `correct: true`;
     `mvgformer_tpu_torch.bench_detail`'s rows topk64_jacobi_ptop4_b1 and
     train_gtmatch_jacobi_b1 (with its _chunk8 row, which the substring
     selects); the forward of `mvgformer_tpu_torch.graft_entry.entry()`
     once; and `graft_entry.dryrun_multichip`'s training and eval step on
     a 2 x 2 grid of ranks sharing the card. Each runs with the kernel
     counts set to 0 before it (`path_launches`; the dry run's on its rank
     0).
 26. the Jacobi DLT (`ops/dlt_jacobi.py`, one forward kernel per decoder
     layer, and one backward kernel in training): 26a at a served layer's
     shapes, 960 points a frame and 5 views at batch 1 and 8, the forward
     kernel against the plain chain (the largest gap on points inside the
     capture space), timed as the other kernels (`ms`, `device_ms`,
     `host_us`) beside the plain chain's `plain_ms` and the launch floor,
     then at the volumetric cell's pelvis (B 1, N 1, V 4: zero logits,
     mask true, the cell's rig) over 64 subjects placed as its frames
     place them, with the same tolerance; 26b at the training layer's shape (1, 15360, 5) the backward kernel's
     gradients of the refined points and logits against autograd through
     `plain_dlt` on the same inputs, both held to the float64 gradient
     (within 2x of float32 autograd's error at the 50/90/99% quantiles of
     the points' errors, 4x at the worst; masked points exact zeros, kept
     ones finite), and the backward timed alone beside the plain chain's
     autograd backward and its bound, the forward at that shape beside
     the plain chain's forward; 26c the flagship bf16 model serves
     a frame at batch 1 and at batch 8, and trains one step, and the
     volumetric cell's configuration serves a frame at full width, with
     the DLT's counts set to 0 before each: a launch per layer and no
     plain call in serving, a forward launch per layer and recompute, a
     backward launch per layer and no plain call in training, one launch,
     no plain call and no host synchronization in the volumetric step;
     26d `python3 -m benchmark.spans` on dq_serve_live_b1,
     dq_serve_offline_b8 and ltvol_serve_live_b1 (10 s each): `mvg.dlt`'s
     ops and host ms a frame, the device ops a frame and the idle share.
 27. point-top-m in ProjAttn (`ops/point_topm.py`, one kernel per decoder
     layer): 27a at the live dense layer's shape (5, 15360, 8, 3, 8) and a
     top-64 layer's (5, 960, 8, 3, 8), m 4, the kernel against the plain
     chain (kept locations equal, weights within rtol 1e-6), timed as the
     other kernels beside the plain chain's `plain_ms` and the bound; 27b
     the flagship bf16 model serves a frame at batch 1 and at batch 8:
     `point_topm.launches` one up per decoder layer.

Phase 10 also holds F.embedding_bag, the library call of B3's function,
against B3's plain versions and times it. The models, batches and window
plans are made on the card by their entry points (device "cuda"). With
--parent DIR (an unpacked parent checkout), B1, B2, B4, B5 and the table
slots (at both their sizes) of DIR and of this checkout are also timed in
turns by tools/launch_cost.py before the table. With --benches-only,
phases 1, 2 and 25 run and nothing else: a reading of the benches inside
this script, to set beside their standalone runs; it prints no kernel
table and no device line. With --dlt-only, phases 1, 2, 14's launch floor
and 26 run and nothing else; with --point-topm-only, phases 1, 2, 14's
launch floor and 27.

The last three lines are the kernel table (each kernel's launches on its
path, worst error, ms, device_ms where measured, plain ms, library ms or
why there is none, its bound from utils/bounds.py on the timed inputs, for
B1, B2, B4 and B5 ptxas's report, with --parent the parent's times (the
table slots' too), and `floor_ms`, the launch floor, once beside the table
and in each row or shape whose bound per launch lies under it), the card,
and the device, as JSON. The `ranking` phase before them orders the
kernels for later work (`ranking`).
"""

import collections
import contextlib
import functools
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

from mvgformer_tpu_torch import bench
from mvgformer_tpu_torch.device import card_line
from mvgformer_tpu_torch.geometry.cameras import CameraParams
from mvgformer_tpu_torch.ops import (_build, deform_attn, dlt_jacobi,
                                     gather_forms, point_topm, sampling,
                                     table_build, table_gather, window_block,
                                     window_dma, window_sampling)
from mvgformer_tpu_torch.tools.launch_cost import (B1_SHAPES,
                                                   DLT_SPACE_CENTER,
                                                   FLAGSHIP_LEVELS,
                                                   device_ms, dlt_inputs,
                                                   level_views,
                                                   sampling_inputs,
                                                   window_inputs)
from mvgformer_tpu_torch.tools.probes.probe_pallas_gather import flat_rows
from mvgformer_tpu_torch.utils import bounds, profiling, yardsticks

REPO = Path(__file__).resolve().parent
SPATIAL_SHAPES = FLAGSHIP_LEVELS
N_VIEWS, HEADS, HEAD_DIM = 5, 8, 32
TRAIN_LQ, TRAIN_P = 1024 * 15, 8  # dense training layer: Q*J queries
SEED = 0
THRESHOLD = 0.1
SERVE_FRAMES, SERVE_WARMUP = 6, 2
WINDOW_FRAMES = 6  # distinct frames per windowed impl, 2 of them warm-up
TRAIN_STEPS, TRAIN_WARMUP = 5, 2
SOURCES = (*bench.MODEL_SOURCES, "gather_forms.cu")
IMPL_KERNEL = {"pallas": window_block.window_block_matmul,
               "pallas_dma": window_dma.window_block_dma}
TRAIN_KERNELS = (table_build.build_corner_table,
                 table_gather.gather_reduce_forward,
                 table_gather.gather_reduce_backward)
ALL_KERNELS = bench.MODEL_KERNELS
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
PROBE_RUNS = ("--runs", "2", "--warmup", "1")
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
# phase 26: a served layer's DLT at batch 1 (live) and 8, 960 points a
# frame (top-64 x 15 joints), 5 views; the benchmark cells it runs
# benchmark.spans on (the volumetric cell's pelvis opens `mvg.dlt` too),
# and the seconds of each
DLT_BATCHES = (1, 8)
DLT_POINTS, DLT_VIEWS = 960, 5
DLT_SPAN_CELLS = ("dq_serve_live_b1", "dq_serve_offline_b8",
                  "ltvol_serve_live_b1")
DLT_SPAN_SECONDS = "10"
DLT_SPAN_SEED = "1800000018"
# the volumetric cell's configuration and traffic: 26a's pelvis shape is
# its DLT of the base joint, one point a frame over its four views
# (`models/volumetric.py::pelvis`), on its rig, at DLT_PELVIS_DRAWS
# subject positions placed as its frames place them; 26c serves one of its
# frames at full width
LT_CONFIG = REPO / "benchmark" / "configs" / "ltvol_h36m4.json"
LT_TRAFFIC = REPO / "benchmark" / "traffic" / "serve_live_solo_b1.json"
DLT_PELVIS_DRAWS = 64
# phase 26b: the training layer's DLT backward, 1 x 1024 queries x 15
# joints over 5 views; the quantiles of the points' gradient errors and
# the factor over float32 autograd's error allowed at each (the card
# tests' rule)
DLT_BWD_SHAPE = (1, 15360, 5)
DLT_BWD_QUANTILES = (0.5, 0.9, 0.99, 1.0)
DLT_BWD_FACTORS = (2.0, 2.0, 2.0, 4.0)
# phase 27: point-top-m at the live dense layer's rows and a top-64
# layer's, (N, Lq, H, Lt, P), m 4; the weights' tolerance (the kept sum is
# added in another order than torch.sum's)
TOPM_SHAPES = ((5, 15360, 8, 3, 8), (5, 960, 8, 3, 8))
TOPM_M = 4
TOPM_RTOL = 1e-6
# launch_cost's kernel sets timed against the parent (--parent)
PARENT_KERNELS = "deform,window_block,window_dma,table_build,table_slots"
NO_LIBRARY = {
    "deform_sample": "none: F.grid_sample is the bilinear read of one "
                     "level and head only; the sum over levels and points "
                     "and the attention weights are further calls",
    "window_block_matmul": "none: no single call reads tent-weighted "
                           "windows by block index",
    "window_block_dma": "none: no single call reads tent-weighted windows "
                        "at block origins",
    "build_corner_table": "none: a pad, four slices and a concatenation",
    "fused_dlt": "none: no library call runs the chain; torch.linalg.eigh "
                 "solves only its 4 x 4 step, by another algorithm",
    "point_topm": "none: torch.topk has no rule among equal values; the "
                  "gathers and the renormalisation are further calls",
    "table_slots": "none: a pad, four slices and a concatenation",
    "gather_reduce_backward": "none in bfloat16: PyTorch's CUDA "
                              "embedding_bag has no bfloat16 backward for "
                              "per-sample weights; float32 beside it",
}
# (kernel, source, replaces, also replaces, library call, the shape of
# phase 14 that the probes launch it at where it is timed at two)
PROBE_ROWS = (
    (gather_forms.row_gather, "gather_forms.cu",
     "tools/probes/probe_pallas_gather.py:40",
     ["tools/probes/probe_pallas_gather.py:70 (make_onehot_kernel)",
      "tools/probes/probe_pallas_gather2.py:84 (onehot_kernel)",
      "tools/probes/probe_mosaic_gather_forms.py:17 (f2, f3, f6)"],
     "torch.index_select", None),
    (gather_forms.window_gather, "gather_forms.cu",
     "tools/probes/probe_onehot_parts.py:41",
     ["tools/probes/probe_sorted_gather_parts.py:116 (kernel)"],
     "torch.index_select", None),
    (gather_forms.take_along, "gather_forms.cu",
     "tools/probes/probe_pallas_gather2.py:60",
     ["tools/probes/probe_pallas_gather.py:40 (take_eq)",
      "tools/probes/probe_mosaic_gather_forms.py:17 (f1, f4, f5)"],
     "torch.gather", None),
    (gather_forms.scale, "gather_forms.cu",
     "tools/probes/probe_pallas_gather2.py:45", [], "torch.mul", "P3"),
    (gather_forms.table_slots, "table_build.cu",
     "tools/probes/probe_table_kernel_forms.py:151", [], None, "P11"),
)
# scale's large case: a flagship level-0 value, (views, h, w, d_model),
# 78.6 MB in bfloat16, over the 50 MB L2
SCALE_VALUE = (5, 128, 240, 256)
TIME_KEYS = ("device_ms", "host_us", "library_device_ms", "library_host_us")


def probe_row(fn, source, replaces, also, library, probe_shape, st,
              launches, turns):
    """The kernels-line row of a probe kernel: its first timed shape's
    times and bound as the row's own. A kernel timed at two shapes lists
    both in `by_shape`, with the path's launches at `probe_shape` (the
    shape the probes run it at) and none at the other, and the parent's
    times of the parent_vs_change case at the same size, where `turns`
    has one."""
    shapes = []
    for group, sh in st["shapes"].items():
        at = "bfloat16; " + " + ".join(sh["at"])
        shapes.append({
            "at": at, "launches": launches if group == probe_shape else 0,
            "timed_launches": len(sh["at"]), "ms": sh["ms"],
            "plain_ms": sh["plain_ms"], "library_ms": sh["library_ms"],
            "bound_ms": sh["work"].bound_ms,
            **{k: sh[k] for k in TIME_KEYS if k in sh},
            **next((t for case, t in turns.items()
                    if case.startswith(fn.__name__)
                    and case.rsplit(" at ", 1)[-1] in at), {})})
    first = next(iter(st["shapes"].values()))
    return kernel_row(
        fn, source, replaces, launches, st["max_abs_err"], first["ms"],
        first["plain_ms"], first["library_ms"], first["work"],
        shapes[0]["at"], timed_launches=len(first["at"]), also=also,
        library=library, by_shape=shapes if len(shapes) > 1 else None,
        **{k: first[k] for k in TIME_KEYS if k in first},
        **{k: v for k, v in shapes[0].items()
           if k.startswith(("parent_", "change_"))})


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
    worst float32 error and, per (Lq, P) in bfloat16 (the DQ model's
    served shapes B1_SHAPES and the MvP baseline's Lq 15360 at P 8), ms,
    device_ms, plain ms and the compulsory work."""
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
            if dtype == torch.bfloat16:
                serving[(Lq, P)] = {
                    "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                    "work": bounds.deform_sample(value, SPATIAL_SHAPES, loc,
                                                 aw)}
    return worst_f32, serving


def window_setup(clamp, cfg=None):
    """The layer-1 plan (on the card) and static centers (on the host) of
    the flagship rig, or of `cfg`'s."""
    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.models.mvgformer import (
        build_layer1_window_plan, layer1_centers_px)

    cfg = cfg or flagship_cfg("float32")
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
    """Layer-1 logits and 3D of two runs at the golden tolerance classes
    (`bench.compare_layer1`), printed as phase `name`."""
    res = bench.compare_layer1(got, want)
    phase(name, **res, card=card, **fields)
    if not res["ok"]:
        fail(f"{name}: the two runs disagree on layer 1")


def check_slice(card):
    """Phase 5: kernel path on the card against the plain path on the CPU,
    flagship width, float32 with TF32 off (`bench.card_vs_cpu`). Returns
    the two models and the frame for phase 6."""
    cfg = flagship_cfg("float32")
    # the same seed gives the same weights and frame on either device
    run = bench.card_vs_cpu(cfg, "cuda", seed=SEED)
    if run["b1_launches"] == 0:
        fail("the card's forward did not launch the kernel")
    compare_layer1("slice_kernel_vs_plain", run["outs"]["dev"],
                   run["outs"]["cpu"], card, gpu_s=run["seconds"]["dev"],
                   cpu_s=run["seconds"]["cpu"])
    return (cfg, run["models"]["cpu"], run["models"]["dev"],
            run["batches"]["cpu"], run["batches"]["dev"], run["outs"]["dev"])


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


def training_layer_inputs(dtype, gen, levels=SPATIAL_SHAPES,
                          head_dim=HEAD_DIM):
    """value, locations and weights of one dense training layer (Lq = 1024
    queries x 15 joints, P = 8) with border and far-outside locations; the
    non-finite ones of `sampling_inputs` are made far-outside, since only
    finite locations reach the table rows."""
    value, loc, aw = sampling_inputs(TRAIN_LQ, TRAIN_P, dtype, gen,
                                     levels=levels, head_dim=head_dim)
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
            # the device alone (device_ms: 50 calls behind a held stream)
            "fwd_device_ms": sum(device_ms(lambda a=a: fwd(*a))[0]
                                 for a in zip(tables, *zip(*samples))),
            "bwd_device_ms": sum(device_ms(lambda a=a: bwd(*a))[0]
                                 for a in zip(tables, *zip(*samples), cts)),
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
                              device_ms=times["fwd_device_ms"],
                              plain_ms=times["plain_fwd_ms"],
                              library_ms=library["library_fwd_ms"],
                              work=work[fwd])
            stats[bwd].update(ms=times["bwd_ms"],
                              device_ms=times["bwd_device_ms"],
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


def card_vs_cpu_train_step(cfg, name):
    """One training step of `cfg` through the kernels on the card and
    through the plain path on the CPU, the same weights and batch: the
    worst relative loss error, the worst gradient error relative to its
    leaf's largest (and that leaf), and the card's kernel launches."""
    from mvgformer_tpu_torch.core.train import (create_train_state,
                                                make_train_step)
    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.models import build_model

    results = []
    for device in ("cuda", "cpu"):
        model = build_model(cfg, device=device,
                            generator=torch.Generator().manual_seed(SEED))
        batch = make_batch(cfg, batch_size=1, seed=SEED, num_people=2,
                           device=device)
        state, tx = create_train_state(cfg, model)
        (_, metrics), counts = count_launches(
            lambda: make_train_step(cfg, model, tx)(state, batch))
        results.append((metrics, {k: p.grad for k, p in
                                  model.named_parameters()}, counts))
    (m_gpu, g_gpu, counts), (m_cpu, g_cpu, _) = results
    if not all(counts[fn.__name__] for fn in TRAIN_KERNELS):
        fail(f"{name}: the card's training step launched {counts}")
    loss_err = max(abs(m_gpu[k].item() - m_cpu[k].item())
                   / max(abs(m_cpu[k].item()), 1e-6) for k in m_cpu)
    grad_err, worst = 0.0, None
    for k, g in g_cpu.items():
        if (g is None) != (g_gpu[k] is None):
            fail(f"{name}: {k} has a gradient on one device only")
        if g is None:
            continue
        rel = ((g_gpu[k].cpu() - g).abs().max()
               / max(g.abs().max().item(), 1e-12)).item()
        if rel > grad_err:
            grad_err, worst = rel, k
    return loss_err, grad_err, worst, counts


def check_train_step(card):
    """Phase 12: one training step of the toy config, kernels on the card
    against the plain path on the CPU, float32 with TF32 off: loss terms
    at rtol 1e-4, every gradient within 1e-3 of its leaf's largest."""
    loss_err, grad_err, worst, _ = card_vs_cpu_train_step(toy_train_cfg(),
                                                          "toy")
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
    gen = torch.Generator().manual_seed(SEED)
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
    levels) into into["gather"], and the level views of its first table
    build (B2's inputs, strided as B2 gets them) into into["build"], and
    call through, so no launch count changes. `into` None records
    nothing."""
    gather, build = sampling.deform_gather_reduce, sampling.build_corner_tables

    def gather_recorder(tables, idx, w4):
        if into is not None and len(into["gather"]) < levels:
            into["gather"].append((tables.detach(), idx, w4.detach()))
        return gather(tables, idx, w4)

    def build_recorder(value_hd, spatial_shapes):
        if into is not None and not into["build"]:
            sizes = [h * w for h, w in spatial_shapes]
            into["build"].extend(
                v.unflatten(2, (h, w)) for v, (h, w) in zip(
                    value_hd.detach().split(sizes, dim=2), spatial_shapes))
        return build(value_hd, spatial_shapes)

    sampling.deform_gather_reduce = gather_recorder
    sampling.build_corner_tables = build_recorder
    try:
        yield
    finally:
        sampling.deform_gather_reduce = gather
        sampling.build_corner_tables = build


B3_KERNELS = {"gather_reduce_fwd_kernel": "fwd",
              "segment_sum_kernel": "bwd", "rows_kernel": "bwd_rows"}


def profile_b3(step, state, batches, gen, levels):
    """torch.profiler over the given training steps, after the timed ones
    (so their peak memory holds no captured operand): the device ms per
    launch of B3's kernels (the backward's two kernels summed per launch)
    and of the sort kernels, by name; and the first decoder layer's B3
    operands and B2 inputs of the first of these steps."""
    from torch.profiler import ProfilerActivity, profile

    captured = {"gather": [], "build": []}
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
    """Phase 13b: B2 and B3 on the flagship training step's own operands
    (the first decoder layer's three levels, captured in phase 13, a random
    cotangent): B2 on the step's level views bit for bit against its plain
    version and against the tables B3 read in the step; B3's forward and
    backward against the plain versions, the backward twice bit for bit,
    untouched rows 0; the samples per row of each level; and times as in
    phase 10."""
    n_levels = len(SPATIAL_SHAPES)
    if (len(captured["gather"]), len(captured["build"])) != (n_levels,
                                                              n_levels):
        fail(f"captured {len(captured['gather'])} gather-reduce calls and "
             f"{len(captured['build'])} table builds in the step")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    tables = [t for t, _, _ in captured["gather"]]
    samples = [(i, w) for _, i, w in captured["gather"]]
    built = [table_build.build_corner_table(v) for v in captured["build"]]
    b2 = {"b2_bitwise_equal": all(
              torch.equal(t, table_build.build_corner_table_plain(v))
              for t, v in zip(built, captured["build"])),
          "b2_equals_step_tables": all(
              torch.equal(t, s) for t, s in zip(built, tables)),
          "b2_views_contiguous": [v.is_contiguous()
                                  for v in captured["build"]]}
    del built
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
          chunk=table_gather.CHUNK, ok=ok, bwd_bit_identical=same, **b2,
          **times, **work, card=card)
    if not (b2["b2_bitwise_equal"] and b2["b2_equals_step_tables"]):
        fail("B2 disagrees with its plain version, or with the tables of "
             "the step, on the training step's level views")
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
    """The probe kernels' cases at the probes' shapes (tools/probes/), at
    B3's flagship level-0 row and, for scale and the table slots, at a
    flagship level-0 size where bytes set the time, in one dtype: (kernel,
    label, args, kwargs, shape); a case with a shape (bfloat16 only) is
    timed into that shape of its kernel's row of the kernels line, the
    row's own shape first."""
    bf16 = dtype == torch.bfloat16

    def timed(shape):
        return shape if bf16 else None

    def table(*shape):
        a = rng.random(shape, dtype=np.float32) - np.float32(0.5)
        return torch.from_numpy(a).to("cuda", dtype)

    def ints(high, *shape):
        return torch.from_numpy(rng.integers(0, high, shape,
                                             dtype=np.int32)).to("cuda")

    rg, wg, ta, sc, ts = (gather_forms.row_gather, gather_forms.window_gather,
                          gather_forms.take_along, gather_forms.scale,
                          gather_forms.table_slots)
    small, big = table(2048, 128), table(31488, 128)
    idx = ints(2048, 30720)
    p7 = (table(40, 31460, 128), ints((31460 - 1024) // 8, 40, 120),
          ints(1024, 40, 61440))
    cases = [
        (rg, "P1/P2/P5 2048 rows S 30720", (small, idx), {}, None),
        (rg, "P1 31488 rows S 30720", (big, ints(31488, 30720)), {}, None),
        (rg, "P6 f2/f3 and f6", (small, idx[:512].contiguous()), {}, None),
        (rg, "P8 one pair R 41620 S 184320",
         (table(41620, 128), ints(41620, 184320)), {}, None),
        (rg, "B3 flagship level 0: 40 x 33280 rows, S 122880",
         (table(40, 33280, 128), ints(33280, 40, 122880)), {},
         timed("B3 flagship level 0")),
        (wg, "P7 select: 40 x 31460 rows, 120 x 512, W 1024", p7,
         dict(W=1024, unit=8), timed("P7")),
        (wg, "P7 copy", p7, dict(W=1024, unit=8, mode="copy"), None),
        (wg, "P7 zero", (table(4, 3000, 128), ints(200, 4, 120),
                         ints(1024, 4, 61440)),
         dict(W=1024, unit=8, mode="zero"), None),
        (wg, "P8 select, escapes clamped, unit 1",
         (table(1, 41620, 128), ints(41620 - 512, 1, 180),
          ints(512, 1, 184320)), dict(W=512, unit=1), None),
        (ta, "P4 take_eq (2048, 128) x (30720, 128)",
         (small, idx[:, None].expand(30720, 128).contiguous(), 0), {},
         timed("P4")),
        (ta, "P6 f1", (small, ints(2048, 512, 128), 0), {}, None),
        (ta, "P6 f4", (table(8, 128), ints(8, 8, 128), 0), {}, None),
        (ta, "P6 f5 axis 1", (table(128, 128), ints(128, 128, 128), 1), {},
         None),
        (sc, f"flagship level-0 value {SCALE_VALUE}, a = 2",
         (table(*SCALE_VALUE), 2.0), {}, timed("flagship value")),
        (sc, "P3 (2048, 128), a = 2", (small, 2.0), {}, timed("P3")),
    ]
    if not bf16:
        cases.append((sc, "a = 0.3", (small, 0.3), {}, None))
    v_small, v_big = table(40, 16, 30, 32), table(40, 128, 240, 32)
    for name, slots in gather_forms.SLOT_MAPS.items():
        cases.append((ts, f"{name} at (128, 240)", (v_big, slots), {},
                      timed("flagship level 0")))
    for name, slots in gather_forms.SLOT_MAPS.items():
        cases.append((ts, f"P11 {name} at (16, 30)", (v_small, slots), {},
                      timed("P11")))
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


def launch_floor(card, rounds=3):
    """The launch floor: the device's ms per launch of an empty kernel
    (`gather_forms.noop`), timed as every kernel is (`device_ms`: 50
    launches behind a sleep kernel), the median of `rounds` readings."""
    t = torch.empty(1, device="cuda")
    readings = [device_ms(lambda: gather_forms.noop(t))
                for _ in range(rounds)]
    floor = float(np.median([ms for ms, _ in readings]))
    phase("launch_floor", floor_ms=floor,
          readings_ms=[ms for ms, _ in readings],
          host_us=[us for _, us in readings], card=card)
    return floor


def check_probe_kernels(card):
    """Phase 14: each probe kernel against its plain version on the card,
    float32 and bfloat16, at the probes' shapes, B3's flagship level-0
    row and scale's and the table slots' flagship sizes: bit for bit
    (scale: exact, and equal to x * 2 at a = 2); the bfloat16 cases of
    each shape of a kernel's table row timed beside their plain version
    and their library call, with their bound from the same inputs.
    Returns, per kernel, its worst error and its timed shapes in order."""
    rng = np.random.default_rng(SEED)
    stats = {k: {"max_abs_err": 0.0, "shapes": {}}
             for k in gather_forms.KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        lines = []
        for kernel, label, args, kwargs, shape in probe_cases(dtype, rng):
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
            if shape is not None:
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
                sh = st["shapes"].setdefault(shape, {
                    "ms": 0.0, "plain_ms": 0.0, "library_ms": None,
                    "work": bounds.Work(0), "at": []})
                for key in ("device_ms", "host_us", "library_device_ms",
                            "library_host_us"):
                    if key in line:
                        sh[key] = sh.get(key, 0.0) + line[key]
                sh["ms"] += line["ms"]
                sh["plain_ms"] += line["plain_ms"]
                if library is not None:
                    sh["library_ms"] = (sh["library_ms"] or 0.0) + line[
                        "library_ms"]
                sh["work"] = sh["work"] + work
                sh["at"].append(label)
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


# phases 18-19: the MvP baseline at the flagship width, and the DQ model's
# options; B1's MvP shape (every layer dense at P 8)
MVP_OVERRIDES = ("TRANSFORMER=multi_view_pose_transformer",
                 "DECODER.projattn_posembed_mode=use_rayconv")
MVP_LQ, MVP_P = 1024 * 15, 8
MVP_SLICE_QUERIES = 64
PROFILE_STEPS = 2
DQ_OPTIONS = {
    "attention_embed": {"feature_update_method": "attention_embed"},
    "init_self_attention": {"init_self_attention": True},
    "bayesian_update": {"bayesian_update": True},
    "share_layer_weights": {"share_layer_weights": True},
    "st": {"triangulation_method": "st"},
    "query_adapt_center": {"init_ref_method": "query_adapt_center"},
}
B1_KERNEL = bench.B1_KERNEL


def mvp_cfg(dtype: str, **decoder):
    """configs/panoptic/knn5-lr4-q1024.yaml at its full width as the MvP
    baseline with camera-ray ProjAttn (fuse_view_feats cat_proj and
    query_adaptation on are the config's defaults)."""
    from mvgformer_tpu_torch.config import load_config

    cfg = load_config(str(FLAGSHIP_CFG), list(MVP_OVERRIDES)
                      + [f"PARALLEL.COMPUTE_DTYPE={dtype}"])
    for key, val in decoder.items():
        setattr(cfg.DECODER, key, val)
    return cfg


def compare_layers(name, got, want, card, **fields):
    """Every layer's logits and 3D of two runs at the golden tolerance
    classes (logits rtol 1e-3 / atol 2e-3, 3D p99 < 2 mm, max < 6 mm)."""
    worst = {"logits_max_abs_err": 0.0, "poses_mm_p99": 0.0,
             "poses_mm_max": 0.0}
    ok = True
    for g, w in zip(got, want):
        lg = g["pred_logits"].float().cpu().numpy()
        lw = w["pred_logits"].float().cpu().numpy()
        err3d = np.abs(g["pred_poses"].float().cpu().numpy()
                       - w["pred_poses"].float().cpu().numpy())
        p99, mx = float(np.percentile(err3d, 99)), float(err3d.max())
        worst["logits_max_abs_err"] = max(worst["logits_max_abs_err"],
                                          float(np.abs(lg - lw).max()))
        worst["poses_mm_p99"] = max(worst["poses_mm_p99"], p99)
        worst["poses_mm_max"] = max(worst["poses_mm_max"], mx)
        ok &= bool(np.allclose(lg, lw, rtol=1e-3, atol=2e-3)
                   and p99 < 2.0 and mx < 6.0 and np.isfinite(lg).all()
                   and np.isfinite(err3d).all())
    phase(name, layers=len(got), ok=ok, card=card, **worst, **fields)
    if not ok or len(got) != len(want):
        fail(f"{name}: the two runs disagree")


def count_launches(fn):
    """Run fn() with every kernel count set to 0; returns its result and
    the counts after it."""
    for k in ALL_KERNELS:
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k.__name__: k.launches for k in ALL_KERNELS}


def profile_window(fn, runs):
    """`utils/profiling.py::profile_window` over `runs` calls of fn(), with
    B1's device ms per launch (`b1_device_ms_per_launch`)."""
    return profiling.profile_window(fn, runs,
                                    per_launch={"b1": B1_KERNEL})


@contextlib.contextmanager
def record_b1_instances(into):
    """While active, ProjAttn's calls of B1 record (L, P, dtype, elements
    per thread) into `into` and call through."""
    from mvgformer_tpu_torch.ops import projattn

    inner = projattn.deform_sample

    def recording(value, shapes, loc, aw):
        out = inner(value, shapes, loc, aw)
        into.append((loc.shape[3], loc.shape[4], str(value.dtype),
                     _build.vector_width(value.shape[3],
                                         value.element_size(), value, loc,
                                         aw, out)))
        return out

    projattn.deform_sample = recording
    try:
        yield
    finally:
        projattn.deform_sample = inner


def check_mvp_slice(card):
    """Phase 18a: one frame of the MvP baseline at the flagship width with
    64 queries, float32 (TF32 off), through the kernels on the card and
    through the plain path on the CPU: every layer at the golden
    classes."""
    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.models import build_model

    cfg = mvp_cfg("float32", num_instance=MVP_SLICE_QUERIES)
    outs, times = [], []
    for device in ("cuda", "cpu"):
        model = build_model(cfg, device=device,
                            generator=torch.Generator().manual_seed(SEED))
        batch = make_batch(cfg, batch_size=1, seed=SEED, num_people=3,
                           device=device)
        t0 = time.perf_counter()
        with torch.inference_mode():
            if device == "cuda":
                out, counts = count_launches(lambda: model(batch))
            else:
                out = model(batch)
        times.append(time.perf_counter() - t0)
        outs.append(out)
        del model
    layers = cfg.DECODER.num_decoder_layers
    if counts != {**{k.__name__: 0 for k in ALL_KERNELS},
                  "deform_sample": layers}:
        fail(f"the MvP forward on the card launched {counts}")
    compare_layers("mvp_slice_kernel_vs_plain", outs[0], outs[1], card,
                   queries=MVP_SLICE_QUERIES, dtype="float32",
                   b1_launches=counts["deform_sample"], gpu_s=times[0],
                   cpu_s=times[1])
    torch.cuda.empty_cache()


def mvp_serve(card):
    """Phase 18b: serve the MvP baseline in bfloat16, batch 1, 1024
    queries, distinct synthetic frames of one rig through make_eval_step:
    B1 once per layer and frame at its L 3 / P 8 instance, nothing else;
    frames/s, latency, peak memory; then a profiler window over 2 frames
    (device idle share, top ops, B1's device ms per launch)."""
    from mvgformer_tpu_torch.core.infer import make_eval_step
    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.models import build_model

    cfg = mvp_cfg("bfloat16")
    Q, J = cfg.DECODER.num_instance, cfg.DECODER.num_keypoints
    layers = cfg.DECODER.num_decoder_layers
    model = build_model(cfg, generator=torch.Generator().manual_seed(SEED))
    frames = [make_batch(cfg, batch_size=1, seed=SEED + 1 + i, num_people=3,
                         cam_seed=SEED) for i in range(SERVE_FRAMES)]
    step = make_eval_step(cfg, model, THRESHOLD)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    instances, times = [], []

    def run():
        with record_b1_instances(instances):
            for i, frame in enumerate(frames):
                t0 = time.perf_counter()
                pred = step(frame)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                if tuple(pred.shape) != (1, Q, J, 5):
                    fail(f"MvP pred shape {tuple(pred.shape)}")
                if not torch.isfinite(pred).all():
                    fail(f"non-finite MvP pred in frame {i}")

    _, launches = count_launches(run)
    want = {**{k.__name__: 0 for k in ALL_KERNELS},
            "deform_sample": layers * len(frames)}
    if launches != want:
        fail(f"MvP serving launched {launches}, expected {want}")
    if set(instances) != {(3, MVP_P, "torch.bfloat16", 8)}:
        fail(f"MvP serving took B1 instances {set(instances)}, expected "
             f"L 3 / P {MVP_P} bfloat16 with 8 elements per thread")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_window(lambda: step(frames[0]), PROFILE_STEPS)
    steady = times[SERVE_WARMUP:]
    phase("mvp_serve", frames=len(frames), batch=1, dtype="bfloat16",
          queries=Q, frames_per_s=len(steady) / sum(steady),
          latency_ms_median=1e3 * float(np.median(steady)),
          first_frame_s=times[0], peak_mem_gib=peak,
          b1_launches_per_frame=launches["deform_sample"] / len(frames),
          b1_instance={"L": 3, "P": MVP_P, "dtype": "bfloat16",
                       "elements_per_thread": 8},
          profile=prof, card=card)
    del model, frames
    torch.cuda.empty_cache()
    return launches, prof


def mvp_train(card):
    """Phases 18c and 18d: train the MvP baseline in bfloat16, batch 1, 2
    warm-up and 3 timed steps through make_train_step (no remat, as JAX's
    MvP model): finite losses, B2 / B3 launches per step (4 layers x 3
    levels each, no B1), non-zero sampler gradients, steps/s, peak memory;
    then a profiler window over 2 steps."""
    from mvgformer_tpu_torch.core.train import (create_train_state,
                                                make_train_step)
    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.models import build_model

    cfg = mvp_cfg("bfloat16")
    layers = cfg.DECODER.num_decoder_layers
    L = len(SPATIAL_SHAPES)
    model = build_model(cfg, generator=torch.Generator().manual_seed(SEED))
    batches = [make_batch(cfg, batch_size=1, seed=SEED + 100 + i,
                          num_people=3, cam_seed=SEED)
               for i in range(TRAIN_STEPS)]
    state, tx = create_train_state(cfg, model)
    step = make_train_step(cfg, model, tx)
    gen = torch.Generator().manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, metrics = [], None

    def run():
        nonlocal state, metrics
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            state, metrics = step(state, batch, gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            bad = [k for k, v in metrics.items() if not torch.isfinite(v)]
            if bad:
                fail(f"non-finite {bad} in MvP training step {i}")

    _, launches = count_launches(run)
    per_step = {"build_corner_table": L * layers,
                "gather_reduce_forward": L * layers,
                "gather_reduce_backward": L * layers}
    want = {**{k.__name__: 0 for k in ALL_KERNELS},
            **{k: n * len(batches) for k, n in per_step.items()}}
    if launches != want:
        fail(f"MvP training launched {launches}, expected {want}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    grads = {}
    for i, layer in enumerate(model.decoder.layers):
        for lin in ("sampling_offsets", "attention_weights", "rayconv",
                    "output_proj"):
            g = layer.proj_attn.get_submodule(lin).weight.grad
            grads[f"layer{i}.{lin}"] = (float("nan") if g is None
                                        else g.abs().max().item())
    dead = [k for k, v in grads.items() if not (math.isfinite(v) and v > 0)]
    if dead:
        fail(f"no finite non-zero MvP gradient reached {dead}")
    steady = times[TRAIN_WARMUP:]
    phase("mvp_train", steps=len(times), batch=1, dtype="bfloat16",
          remat=False, dropout=cfg.DECODER.dropout,
          steps_per_s=len(steady) / sum(steady), first_step_s=times[0],
          step_s=times, peak_mem_gib=peak,
          losses={k: v.item() for k, v in metrics.items()},
          launches_per_step=per_step, sampler_grad_max_abs=grads,
          card=card)
    prof = profile_window(lambda: step(state, batches[0], gen),
                          PROFILE_STEPS)
    phase("mvp_train_profile", **prof, card=card)
    del model, state, batches
    torch.cuda.empty_cache()
    return launches, prof


def check_option(name, cfg, card):
    """Phase 19a for one option: one serving frame and one training step
    of `cfg`, card against CPU, float32 (TF32 off): every layer at the
    golden classes, the loss terms at rtol 1e-4, every gradient within
    1e-3 of its leaf's largest. Returns the step's launches."""
    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.models import build_model

    outs = []
    for device in ("cuda", "cpu"):
        model = build_model(cfg, device=device,
                            generator=torch.Generator().manual_seed(SEED))
        batch = make_batch(cfg, batch_size=1, seed=SEED, num_people=2,
                           device=device)
        with torch.inference_mode():
            outs.append(model(batch, threshold=THRESHOLD))
    compare_layers("dq_option_forward_card_vs_cpu", outs[0], outs[1], card,
                   option=name)
    loss_err, grad_err, worst, counts = card_vs_cpu_train_step(cfg, name)
    ok = loss_err <= 1e-4 and grad_err <= 1e-3
    phase("dq_option_train_step_card_vs_cpu", option=name,
          loss_max_rel_err=loss_err, grad_max_rel_err=grad_err,
          worst_grad=worst, launches=counts, ok=ok, card=card)
    if not ok:
        fail(f"{name}: the card's training step disagrees with the CPU's")
    return counts


def flagship_train_once(cfg, batches):
    """A fresh flagship-width model from SEED, 1 warm-up and 1 timed
    training step on `batches`: (first step's losses, its gradients in
    float32, the timed step's s, peak GiB, launches per step)."""
    from mvgformer_tpu_torch.core.train import (create_train_state,
                                                make_train_step)
    from mvgformer_tpu_torch.models import build_model

    model = build_model(cfg, generator=torch.Generator().manual_seed(SEED))
    state, tx = create_train_state(cfg, model)
    step = make_train_step(cfg, model, tx)
    gen = torch.Generator().manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (state, first), counts = count_launches(
        lambda: step(state, batches[0], gen))
    grads = {k: p.grad.float().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    t0 = time.perf_counter()
    step(state, batches[1], gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del model, state
    torch.cuda.empty_cache()
    return ({k: v.item() for k, v in first.items()}, grads, seconds, peak,
            counts)


def dq_options(card):
    """Phase 19: each DQ option at the toy width, card against CPU; then
    the flagship training config at full width, one step each with
    TRAIN.SAMPLE_CHUNKS 8 and with REMAT_POLICY 'save_sampled', against
    the plain setting: the same first-step losses within bfloat16 2e-2 and
    every gradient within 2e-2 of its leaf's largest entry (a dropped
    gradient is off by 1), the plain step's B2 / B3 launches per step,
    steps/s and peak memory."""
    from mvgformer_tpu_torch.config import load_config
    from mvgformer_tpu_torch.data.synthetic import make_batch

    option_launches = {}
    for name, overrides in DQ_OPTIONS.items():
        cfg = toy_train_cfg()
        for key, val in overrides.items():
            setattr(cfg.DECODER, key, val)
        counts = check_option(name, cfg, card)
        for k, n in counts.items():
            option_launches[k] = option_launches.get(k, 0) + n

    base = load_config(str(FLAGSHIP_CFG))
    base.DECODER.triangulation_method = "jacobi"
    base.PARALLEL.COMPUTE_DTYPE = "bfloat16"
    batches = [make_batch(base, batch_size=1, seed=SEED + 200 + i,
                          num_people=3, cam_seed=SEED) for i in range(2)]
    layers, L = base.DECODER.num_decoder_layers, len(SPATIAL_SHAPES)
    runs, grads = {}, {}
    for name, (section, key, val) in (
            ("plain", (None, None, None)),
            ("sample_chunks_8", ("TRAIN", "SAMPLE_CHUNKS", 8)),
            ("save_sampled", ("PARALLEL", "REMAT_POLICY", "save_sampled"))):
        cfg = load_config(str(FLAGSHIP_CFG))
        cfg.DECODER.triangulation_method = "jacobi"
        cfg.PARALLEL.COMPUTE_DTYPE = "bfloat16"
        if section is not None:
            setattr(getattr(cfg, section), key, val)
        losses, grads[name], seconds, peak, counts = flagship_train_once(
            cfg, batches)
        want = {"build_corner_table": 2 * L * layers,
                "gather_reduce_forward": 2 * L * layers,
                "gather_reduce_backward": L * layers}
        got = {k: counts[k] for k in want}
        if got != want or counts["deform_sample"]:
            fail(f"{name}: launches per step {counts}, expected {want}")
        runs[name] = {"losses": losses, "steps_per_s": 1.0 / seconds,
                      "peak_mem_gib": peak, "launches_per_step": got}
    worst, grad_worst = 0.0, 0.0
    plain_grads = grads.pop("plain")
    if not plain_grads:
        fail("the plain flagship step left no gradient")
    for name in ("sample_chunks_8", "save_sampled"):
        for k, v in runs["plain"]["losses"].items():
            got = runs[name]["losses"][k]
            worst = max(worst, abs(got - v) / max(abs(v), 1.0))
            if not math.isclose(got, v, rel_tol=2e-2, abs_tol=2e-2):
                fail(f"{name}: {k} {got} against {v} without it")
        if grads[name].keys() != plain_grads.keys():
            fail(f"{name}: gradients of other parameters than the plain "
                 f"step's")
        for k, want_g in plain_grads.items():
            err = ((grads[name][k] - want_g).abs().max()
                   / want_g.abs().max().clamp_min(1e-12)).item()
            grad_worst = max(grad_worst, err)
            if not err <= 2e-2:
                fail(f"{name}: gradient of {k} off by {err} of its largest")
    phase("dq_options", options=list(DQ_OPTIONS),
          option_launches=option_launches, flagship_train=runs,
          loss_max_rel_err=worst, grad_max_rel_err=grad_worst, card=card)
    return option_launches, runs


# phases 20-22: data parallelism over ranks, the debug dumps, the stage
# split of a served frame
DP_RANKS, DP_STEPS = 2, 3
DP_LOSSES = ("total", "loss_ce", "loss_pose_perjoint",
             "loss_pose_perprojection_2d", "loss_init")
TORCHRUN = (sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(DP_RANKS))
DEBUG_VALIDATE = ("DATASET.MAX_DATA_NUM=2", "TEST.BATCH_SIZE=2",
                  "DEBUG.VISUALIZATION_JUMP_NUM=0", "DEBUG.DEBUG=true")
STAGE_FRAMES = 4  # the first one warm-up
F32_GRAD_BOUND = 2e-2
# the bf16 gradient bound of phases 20a and 23c, per leaf: a split run's
# bf16 gradient and one process's are each one bf16 rounding from the
# float32 gradient of the same inputs, so they lie at most twice that
# rounding apart. The rounding is measured in the same run: the one
# process's bf16 gradient of the leaf against its float32 one.
BF16_ROUNDING_MARGIN = 2.0



class Stopwatch:
    """Wall seconds per named stage, each stage ending with a synchronize
    of `device`: the synchronizing splits of phases 20a, 22 and 23 (the
    program's spans, `utils/profiling.span`, split a frame on the
    profiler's clock without synchronizing)."""

    def __init__(self, device):
        self.device = device
        self.totals = collections.defaultdict(float)
        self.counts = collections.defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name):
        start = time.perf_counter()
        yield
        profiling.synchronize(self.device)
        self.totals[name] += time.perf_counter() - start
        self.counts[name] += 1

    def time_fn(self, name, fn, *args, **kwargs):
        """fn(*args, **kwargs) as the stage `name`."""
        with self.stage(name):
            return fn(*args, **kwargs)

    def summary(self):
        """Mean seconds per call of each stage."""
        return {k: self.totals[k] / self.counts[k] for k in self.totals}

def dp_train_cfg(dtype="bfloat16"):
    """Phase 13's flagship training config (gt match, Jacobi, remat) in
    `dtype` with dropout 0: each rank draws its own masks."""
    from mvgformer_tpu_torch.config import load_config

    cfg = load_config(str(FLAGSHIP_CFG))
    cfg.DECODER.triangulation_method = "jacobi"
    cfg.DECODER.dropout = 0.0
    cfg.PARALLEL.COMPUTE_DTYPE = dtype
    return cfg


def dp_global_batch(cfg, device):
    from mvgformer_tpu_torch.data.synthetic import make_batch

    return make_batch(cfg, batch_size=DP_RANKS, seed=SEED + 200,
                      num_people=3, cam_seed=SEED, device=device)


def dp_step_worker(dp, cfg, steps, out_dir):
    """Phase 20a on one rank (spawned by `parallel.spawn`): the model from
    SEED, rank 0's weights broadcast, this rank's row of the global batch,
    one `make_train_step(..., dp=)` whose metrics, reduced gradients and
    updated parameters go to <out_dir>/rank<r>.pt; then (`steps` > 0)
    `steps` timed steps with the kernel counts set to 0 before them, and
    a Stopwatch around each step and each gradient all-reduce, into
    rank<r>.json."""
    from mvgformer_tpu_torch.core import train as core_train
    from mvgformer_tpu_torch.device import strict_float32
    from mvgformer_tpu_torch.models.mvgformer import MVGFormer
    from mvgformer_tpu_torch.parallel import replicated, shard_batch

    strict_float32()
    model = MVGFormer(cfg, generator=torch.Generator().manual_seed(SEED),
                      device=dp.device)
    replicated(model, dp)
    local = shard_batch(dp_global_batch(cfg, dp.device), dp)
    state, tx = core_train.create_train_state(cfg, model)
    timer = Stopwatch(dp.device)
    reduce = core_train.all_reduce_grads
    core_train.all_reduce_grads = functools.partial(
        timer.time_fn, "all_reduce", reduce)
    step = core_train.make_train_step(cfg, model, tx, dp=dp)
    state, metrics = step(state, local)
    torch.save({"metrics": {k: v.item() for k, v in metrics.items()},
                "grads": {k: p.grad.float().cpu()
                          for k, p in model.named_parameters()
                          if p.grad is not None},
                "params": {k: p.detach().cpu()
                           for k, p in model.named_parameters()}},
               Path(out_dir) / f"rank{dp.rank}.pt")
    if not steps:
        core_train.all_reduce_grads = reduce
        return None
    timer = Stopwatch(dp.device)
    core_train.all_reduce_grads = functools.partial(
        timer.time_fn, "all_reduce", reduce)
    count_kernels()
    for _ in range(steps):
        with timer.stage("step"):
            state, _ = step(state, local)
    core_train.all_reduce_grads = reduce
    stats = {"rank": dp.rank, "world": dp.world, "backend": dp.backend,
             "device": str(dp.device),
             "steps_per_s": steps / timer.totals["step"],
             "step_ms": 1e3 * timer.summary()["step"],
             "all_reduce_ms": 1e3 * timer.summary()["all_reduce"],
             "all_reduce_share": timer.totals["all_reduce"]
             / timer.totals["step"],
             "launches_per_step": {fn.__name__: fn.launches / steps
                                   for fn in TRAIN_KERNELS},
             "peak_mem_gib": (torch.cuda.max_memory_allocated(dp.device)
                              / 2 ** 30 if dp.device.type == "cuda"
                              else None)}
    (Path(out_dir) / f"rank{dp.rank}.json").write_text(json.dumps(stats))
    return stats


def leaf_gaps(got, want):
    """max|got - want| / max|want| of every leaf of `want`."""
    return {k: ((got[k].to(w.device) - w).abs().max()
                / max(w.abs().max().item(), 1e-12)).item()
            for k, w in want.items()}


def bf16_grad_bounds(want_bf16, want_f32):
    """Per leaf of `want_bf16` (one process's bf16 gradients): the larger
    of F32_GRAD_BOUND and BF16_ROUNDING_MARGIN times the leaf's rounding,
    its gap from the same process's float32 gradient `want_f32`. Returns
    ({leaf: bound}, {leaf: rounding})."""
    rounding = leaf_gaps(want_bf16, want_f32)
    return ({k: max(F32_GRAD_BOUND, BF16_ROUNDING_MARGIN * r)
             for k, r in rounding.items()}, rounding)


def grad_check(got, want, bounds):
    """`got` against `want` leaf by leaf, each within its bound (`bounds`
    a number or {leaf: bound}): (ok, the worst gap, its leaf, the worst
    gap's share of its bound, the leaves over their bound with gap and
    bound)."""
    missing = sorted(set(want) - set(got))
    if missing:
        fail(f"{missing} have no gradient after the reduction")
    gaps = leaf_gaps(got, want)
    bound = (bounds if isinstance(bounds, dict)
             else dict.fromkeys(gaps, bounds))
    over = {k: (g, bound[k]) for k, g in gaps.items() if g > bound[k]}
    worst = max(gaps, key=gaps.get)
    share = max(g / bound[k] for k, g in gaps.items())
    return not over, gaps[worst], worst, share, over


def dp_single(cfg, device):
    """One process's flagship step on the 2-frame global batch: its loss
    terms and gradients."""
    from mvgformer_tpu_torch.core.train import (create_train_state,
                                                make_train_step)
    from mvgformer_tpu_torch.models.mvgformer import MVGFormer

    model = MVGFormer(cfg, generator=torch.Generator().manual_seed(SEED),
                      device=device)
    state, tx = create_train_state(cfg, model)
    _, metrics = make_train_step(cfg, model, tx)(
        state, dp_global_batch(cfg, device))
    losses = {k: metrics[k].item() for k in DP_LOSSES}
    grads = {k: p.grad.float() for k, p in model.named_parameters()
             if p.grad is not None}
    del model, state
    if device == "cuda":
        torch.cuda.empty_cache()
    return losses, grads


def dp_train(card, device="cuda", cfgs=None):
    """Phase 20a: the flagship training step on DP_RANKS ranks, one frame
    each, against one process taking the same 2-frame global batch on the
    card. In float32 (TF32 off) the loss terms (the ranks' mean) within
    rtol 1e-4 and every reduced gradient within 2e-2 of its leaf's
    largest; in bf16 the loss terms within 2e-2 and every gradient within
    its `bf16_grad_bounds` of its leaf's largest (the 1-frame and 2-frame
    shapes round apart, most in layer 1's sampling_offsets, and the
    bound follows bf16's own rounding of the leaf, which the one process
    measures from its float32 step). Both: the ranks' gradients and
    parameters after the
    Adam step equal bit for bit, B2 / B3 launches per step on each rank;
    in bf16 steps/s per rank over DP_STEPS steps and the all-reduce's
    share of a step. Two ranks share cuda:0 over gloo (the backend rule); where the
    machine shows 2 or more cards, the same again on two cards over NCCL.
    Returns each bf16 run's per-rank stats. `device` and `cfgs` (dtype ->
    config) let the phase be rehearsed at a toy size on the CPU."""
    from mvgformer_tpu_torch.parallel import choose_backend, spawn

    runs = {}
    cards = torch.cuda.device_count()
    f32_grads = None
    for dtype, loss_tol, steps in (("float32", 1e-4, 0),
                                   ("bfloat16", 2e-2, DP_STEPS)):
        cfg = (cfgs or {}).get(dtype) or dp_train_cfg(dtype)
        want_losses, want_grads = dp_single(cfg, device)
        rounding = None
        if dtype == "float32":
            f32_grads, grad_tol = want_grads, F32_GRAD_BOUND
        else:
            grad_tol, rounding = bf16_grad_bounds(want_grads, f32_grads)
        for name, visible in (("one_card", 1), ("two_cards", 2)):
            if cards < visible:
                phase("dp_train", run=name, dtype=dtype,
                      skipped=f"{cards} card(s) visible", card=card)
                continue
            backend = choose_backend("cuda", DP_RANKS, visible)
            with tempfile.TemporaryDirectory(prefix="dp-",
                                             dir=REPO / "build") as out, \
                    visible_devices(visible):
                t0 = time.perf_counter()
                spawn(dp_step_worker, DP_RANKS, device, cfg, steps, out)
                seconds = time.perf_counter() - t0
                ranks = [torch.load(Path(out) / f"rank{r}.pt")
                         for r in range(DP_RANKS)]
                stats = [json.loads((Path(out) / f"rank{r}.json")
                                    .read_text())
                         for r in range(DP_RANKS)] if steps else None
            loss_gap = max(abs(ranks[0]["metrics"][k] - v)
                           / max(abs(v), 1e-6)
                           for k, v in want_losses.items())
            got = {k: g.to(device) for k, g in ranks[0]["grads"].items()}
            grad_ok, grad_err, worst, bound_share, over = grad_check(
                got, want_grads, grad_tol)
            params_equal = all(torch.equal(p, ranks[1]["params"][k])
                               for k, p in ranks[0]["params"].items())
            grads_equal = all(torch.equal(g, ranks[1]["grads"][k])
                              for k, g in ranks[0]["grads"].items())
            ok = (loss_gap <= loss_tol and params_equal and grads_equal
                  and grad_ok)
            phase("dp_train", run=name, backend=backend, world=DP_RANKS,
                  cfg=str(FLAGSHIP_CFG.relative_to(REPO)), dtype=dtype,
                  dropout=0.0, frames_per_rank=1,
                  loss_max_rel_gap=loss_gap, loss_tol=loss_tol,
                  grad_max_rel_gap=grad_err, worst_grad=worst,
                  **grad_bound_fields(grad_tol, rounding, worst,
                                      bound_share, over),
                  leaves=len(want_grads),
                  params_equal_on_ranks=params_equal,
                  grads_equal_on_ranks=grads_equal,
                  reduced_floats=sum(g.numel() for g in ranks[0]["grads"]
                                     .values()),
                  losses={k: ranks[0]["metrics"][k] for k in DP_LOSSES},
                  single_process_losses=want_losses, per_rank=stats,
                  seconds=seconds, ok=ok, card=card)
            if not ok:
                fail(f"the {DP_RANKS}-rank step ({name}, {backend}, "
                     f"{dtype}) disagrees with one process")
            if not steps:
                continue
            want = {fn.__name__: n for fn, n in zip(
                TRAIN_KERNELS, (24, 24, 12))}
            if any(s["launches_per_step"] != want for s in stats):
                fail(f"B2 / B3 launches per step per rank "
                     f"{[s['launches_per_step'] for s in stats]}, "
                     f"expected {want}")
            runs[name] = stats
    del want_grads, f32_grads
    return runs


def grad_bound_fields(grad_tol, rounding, worst, bound_share, over):
    """The phase line's fields of a gradient gate: the bound of the worst
    leaf, its bf16 rounding where bf16 (`bf16_grad_bounds`), the largest
    share of a leaf's bound taken and the leaves over their bound."""
    bounded = isinstance(grad_tol, dict)
    fields = {"grad_tol": grad_tol[worst] if bounded else grad_tol,
              "grad_max_share_of_bound": bound_share,
              "leaves_over_bound": over}
    if rounding is not None:
        top = sorted(rounding, key=rounding.get, reverse=True)[:3]
        fields.update(worst_grad_bf16_rounding=rounding[worst],
                      largest_bf16_rounding={k: rounding[k] for k in top},
                      grad_bound="max(2e-2, 2 x the leaf's bf16 rounding)")
    return fields


@contextlib.contextmanager
def visible_devices(n):
    """Spawned ranks see the first `n` cards (CUDA_VISIBLE_DEVICES)."""
    import os

    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(str(i) for i in range(n))
    try:
        yield
    finally:
        if saved is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved


def torchrun(args, timeout=600):
    """`python -m torch.distributed.run --standalone --nproc_per_node
    DP_RANKS` over a module and its arguments, from the checkout's root;
    fails on a non-zero exit with the end of its output."""
    t0 = time.perf_counter()
    proc = subprocess.run([*TORCHRUN, *args], cwd=REPO, capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-8000:], flush=True)
        fail(f"torchrun {' '.join(args[:2])} exited {proc.returncode}")
    return time.perf_counter() - t0, proc.stderr


def dp_cli_train(card, out_dir):
    """Phase 20b: the train CLI under torchrun, DP_RANKS ranks on the
    visible cards, on configs/synthetic_ap_ablation.yaml with
    CLI_TRAIN_ARGS (3 steps over global batches of 2 frames): one log and
    one checkpoint directory under OUTPUT_DIR, the log names the world and
    the backend, the epoch's mean losses finite, and the checkpoint
    (step 3) loads into the model with weights_only=True."""
    from mvgformer_tpu_torch.config import load_config
    from mvgformer_tpu_torch.models import build_model

    out = Path(out_dir) / "train"
    seconds, _ = torchrun(["-m", "mvgformer_tpu_torch.run.train", "--cfg",
                           str(ABLATION_CFG), *CLI_TRAIN_ARGS,
                           f"OUTPUT_DIR={out}"])
    logs = list(out.glob("*/*/*_train.log"))
    ckpt_dirs = list(out.glob("*/*/checkpoints"))
    if len(logs) != 1 or len(ckpt_dirs) != 1:
        fail(f"the torchrun train CLI wrote {len(logs)} logs and "
             f"{len(ckpt_dirs)} checkpoint directories")
    log = logs[0].read_text()
    done = [line for line in log.splitlines() if "epoch 0 done" in line]
    losses = dict(kv.split("=") for kv in done[-1].split("| ")[-1].split()
                  if "=" in kv) if done else {}
    finite = bool(losses) and all(math.isfinite(float(v))
                                  for v in losses.values())
    payload = torch.load(ckpt_dirs[0] / "0.pt", weights_only=True)
    cfg = load_config(str(ABLATION_CFG),
                      [a for a in CLI_TRAIN_ARGS if "=" in a])
    model = build_model(cfg, generator=torch.Generator().manual_seed(SEED))
    model.load_state_dict(payload["model"])
    backend_line = f"rank 0 of {DP_RANKS}, backend"
    ok = finite and payload["step"] == 3 and backend_line in log
    phase("dp_cli_train", launcher=" ".join(TORCHRUN[1:]),
          cli="mvgformer_tpu_torch.run.train",
          cfg=str(ABLATION_CFG.relative_to(REPO)), args=list(CLI_TRAIN_ARGS),
          backend=log.split(backend_line)[1].split()[0].strip(",)")
          if backend_line in log else None,
          checkpoint_step=payload["step"], epoch_mean_losses=losses,
          eval_logged="eval epoch 0 thr" in log, seconds=seconds, ok=ok,
          card=card)
    if not ok:
        fail("the torchrun train CLI's run is not whole")


def dp_cli_validate(card, out_dir):
    """Phase 20c: the validate CLI at the flagship width with
    FLAGSHIP_VALIDATE (8 synthetic frames, top-64, point-top-4, Jacobi,
    bf16, random weights) under torchrun on DP_RANKS ranks, each 4 frames
    per batch of 8, against the 1-rank CLI in this process at batches of
    4 (the same shapes per rank): the gathered preds at the golden
    classes (3D p99 < 2 mm, max < 6 mm; the kept flags equal), frames/s
    of both loops."""
    from mvgformer_tpu_torch.config import load_config
    from mvgformer_tpu_torch.run import validate as validate_cli

    fcfg = load_config(str(FLAGSHIP_CFG), list(FLAGSHIP_VALIDATE))
    thr = fcfg.DECODER.inference_conf_thr[0]
    preds = {}
    out = Path(out_dir) / "validate"
    seconds, _ = torchrun(["-m", "mvgformer_tpu_torch.run.validate",
                           "--cfg", str(FLAGSHIP_CFG), *FLAGSHIP_VALIDATE,
                           "TEST.BATCH_SIZE=8", f"OUTPUT_DIR={out / 'two'}"])
    log = next((out / "two").glob("*/*/*_validate.log")).read_text()
    loop = [line for line in log.splitlines() if "eval loop:" in line][0]
    two_fps = float(loop.split("(")[1].split()[0])
    preds["two"] = np.load(next((out / "two").glob(f"*/*/preds-{thr}.npy")))
    t0 = time.perf_counter()
    res = validate_cli.main(["--cfg", str(FLAGSHIP_CFG), *FLAGSHIP_VALIDATE,
                             "TEST.BATCH_SIZE=4", f"OUTPUT_DIR={out / 'one'}"])
    one_seconds = time.perf_counter() - t0
    preds["one"] = np.load(next((out / "one").glob(f"*/*/preds-{thr}.npy")))
    got, want = preds["two"], preds["one"]
    err = np.abs(got[..., :3] - want[..., :3])
    flags_equal = bool(np.array_equal(got[..., 3], want[..., 3]))
    ok = bool(got.shape == want.shape and flags_equal
              and np.percentile(err, 99) < 2.0 and err.max() < 6.0)
    loop_one = res[thr]["loop"]
    phase("dp_cli_validate", launcher=" ".join(TORCHRUN[1:]),
          cli="mvgformer_tpu_torch.run.validate",
          cfg=str(FLAGSHIP_CFG.relative_to(REPO)),
          args=list(FLAGSHIP_VALIDATE), frames=int(got.shape[0]),
          two_ranks_frames_per_s=two_fps, two_ranks_seconds=seconds,
          one_rank_frames_per_s=loop_one["frames"] / loop_one["loop_s"],
          one_rank_seconds=one_seconds,
          poses_mm_p99=float(np.percentile(err, 99)),
          poses_mm_max=float(err.max()),
          bit_equal=bool(np.array_equal(got, want)),
          flags_equal=flags_equal, ok=ok, card=card)
    if not ok:
        fail("the 2-rank validate CLI's preds differ from the 1-rank CLI's")


def debug_dumps(card, out_dir):
    """Phase 21: the debug dumps on the card. Whether matplotlib is there
    is printed first. The toy width's taps (sampling locations and
    weights of every layer), card against CPU in float32 (TF32 off),
    within 1e-4; then, with matplotlib, the validate CLI with
    DEBUG_VALIDATE (VISUALIZATION_JUMP_NUM 0, DEBUG.DEBUG, 2 frames) at
    the flagship width, listing the files it wrote; without it the
    flagship frame's taps and the epipolar pickle only."""
    import importlib.util

    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.models import build_model

    have_mpl = importlib.util.find_spec("matplotlib") is not None
    phase("debug_plotting", matplotlib=have_mpl,
          plan="validate CLI dumps" if have_mpl
          else "taps and the epipolar pickle only", card=card)
    cfg = toy_train_cfg()
    taps = {}
    for device in ("cuda", "cpu"):
        model = build_model(cfg, device=device,
                            generator=torch.Generator().manual_seed(SEED))
        batch = make_batch(cfg, batch_size=1, seed=SEED, num_people=2,
                           device=device)
        with torch.no_grad():
            _, inter = model(batch, threshold=THRESHOLD,
                             return_intermediates=True)
        taps[device] = {(layer, key): vals[0].float().cpu()
                        for layer, sub in inter["decoder"].items()
                        for key, vals in sub["proj_attn"].items()}
    errs = {f"{layer}/{key}": (taps["cuda"][layer, key]
                               - taps["cpu"][layer, key]).abs().max().item()
            for layer, key in taps["cpu"]}
    ok = len(errs) == 2 * cfg.DECODER.num_decoder_layers and max(
        errs.values()) <= 1e-4
    phase("debug_taps_card_vs_cpu", dtype="float32", max_abs_err=errs,
          ok=ok, card=card)
    if not ok:
        fail("the card's debug taps disagree with the CPU's")

    out = Path(out_dir) / "debug"
    t0 = time.perf_counter()
    if have_mpl:
        from mvgformer_tpu_torch.run import validate as validate_cli

        validate_cli.main(["--cfg", str(FLAGSHIP_CFG), *FLAGSHIP_VALIDATE,
                           *DEBUG_VALIDATE, f"OUTPUT_DIR={out}"])
    else:
        from mvgformer_tpu_torch.utils.visualization import \
            save_debug_epipolar_dump

        fcfg = flagship_cfg("bfloat16")
        model = build_model(fcfg, generator=torch.Generator().manual_seed(
            SEED))
        batch = make_batch(fcfg, batch_size=1, seed=SEED + 1, num_people=3,
                           cam_seed=SEED)
        with torch.inference_mode():
            model(batch, threshold=THRESHOLD, return_intermediates=True)
        save_debug_epipolar_dump(batch.to("cpu"),
                                 str(out / "vis" / "frame0"))
        del model
    files = sorted(str(p.relative_to(out)) for p in out.rglob("*")
                   if p.is_file() and "vis" in p.parts)
    want = ({"frame0_epipolar.pkl", "frame1_epipolar.pkl",
             "0_joints3d.png", "1_joints3d.png"} if have_mpl
            else {"frame0_epipolar.pkl"})
    ok = want <= {Path(f).name for f in files}
    phase("debug_dumps", cfg=str(FLAGSHIP_CFG.relative_to(REPO)),
          args=list(FLAGSHIP_VALIDATE) + list(DEBUG_VALIDATE)
          if have_mpl else None, files=files, n_files=len(files),
          seconds=time.perf_counter() - t0, ok=ok, card=card)
    if not ok:
        fail(f"the debug dumps are missing {want}")
    torch.cuda.empty_cache()


def stage_split(card):
    """Phase 22: a Stopwatch around the flagship served frame (bf16,
    batch 1, top-64, point-top-4, Jacobi, through the gather) and around
    its backbone and each decoder layer (each stage ends with a
    synchronize); `rest` is the frame less those stages (the query and
    reference set-up, the pred assembly). STAGE_FRAMES frames, the first
    one warm-up."""
    from mvgformer_tpu_torch.core.infer import make_eval_step
    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.models.mvgformer import MVGFormer

    cfg = flagship_cfg("bfloat16")
    model = MVGFormer(cfg, generator=torch.Generator().manual_seed(SEED))
    frames = [make_batch(cfg, batch_size=1, seed=SEED + 300 + i,
                         num_people=3, cam_seed=SEED)
              for i in range(STAGE_FRAMES)]
    step = make_eval_step(cfg, model, THRESHOLD)
    timer = Stopwatch("cuda")
    stages = [("backbone", model.backbone)] + [
        (f"layer_{i}", layer) for i, layer in enumerate(model.decoder.stack)]
    for name, module in stages:
        module.forward = functools.partial(timer.time_fn, name,
                                           module.forward)
    step(frames[0])
    torch.cuda.synchronize()
    timer.totals.clear()
    timer.counts.clear()
    for batch in frames[1:]:
        with timer.stage("frame"):
            step(batch)
    for _, module in stages:
        del module.forward
    mean = {k: 1e3 * v for k, v in timer.summary().items()}
    rest = mean["frame"] - sum(mean[name] for name, _ in stages)
    phase("stage_split", cfg=str(FLAGSHIP_CFG.relative_to(REPO)),
          dtype="bfloat16", frames=len(frames) - 1,
          ms={**{name: mean[name] for name, _ in stages}, "rest": rest},
          frame_ms=mean["frame"], frames_per_s=1e3 / mean["frame"],
          card=card)
    del model
    torch.cuda.empty_cache()


# phase 23: view parallelism, one flagship frame's 5 views over the
# ranks of a (1 x VP_VIEWS) grid
VP_VIEWS = 5
VP_FRAMES, VP_WARMUP = 4, 2  # timed bf16 frames per rank, warm-up first
VP_STEPS = 2                 # timed bf16 training steps per rank
VP_TIE = 1e-6                # a near-tie at the K-th score, relative
# a token whose projection the two runs put on either side of an image
# edge (`bounds_flips`) is left out of the comparison: at most
# VP_MAX_FLIPS of them per served config and rank, each within VP_EDGE_PX
# of the edge in both runs (the one such token of 23d, on an NVIDIA H100
# 80GB HBM3, lay 0.004-0.014 px from the edge; tests/vp_card_diagnosis.py)
VP_MAX_FLIPS, VP_EDGE_PX = 1, 0.1
# 23a's bf16 served frame against one process, relative to the largest
# logit and the largest 3D coordinate: this phase's reading on an NVIDIA
# H100 80GB HBM3 at 700 W (logits 2.18e-3, 3D 1.31e-4, 0.45 mm) times a
# margin of 4
BF16_SERVE_BOUND = {"logits_rel": 4 * 2.18e-3, "poses_rel": 4 * 1.31e-4}


def vp_serve_cfgs():
    """23a-23b, 23d: the served configs, name -> config."""
    windowed = flagship_cfg("float32")
    windowed.DECODER.layer1_windowed_sampling = True
    windowed.DECODER.layer1_window_impl = "pallas_dma"
    return {"dq_f32": flagship_cfg("float32"),
            "dq_bf16": flagship_cfg("bfloat16"),
            "dq_windowed_f32": windowed,
            "mvp_f32": mvp_cfg("float32")}


def vp_frame(cfg, device, batch_size=1):
    from mvgformer_tpu_torch.data.synthetic import make_batch

    return make_batch(cfg, batch_size=batch_size, seed=SEED + 500,
                      num_people=3, cam_seed=SEED, device=device)


def timed_collectives(timer, device):
    """Time every collective of `parallel/collectives.py` under the stage
    'collectives' of `timer`: a synchronize before (so that the work
    queued before it is not counted) and after each. Returns the undo."""
    from mvgformer_tpu_torch.parallel import collectives
    from mvgformer_tpu_torch.utils.profiling import synchronize

    saved = {k: getattr(collectives, k) for k in
             ("all_reduce_sum", "all_reduce_max", "all_gather")}

    def wrap(fn):
        def timed(*args, **kwargs):
            synchronize(device)
            return timer.time_fn("collectives", fn, *args, **kwargs)
        return timed

    for k, fn in saved.items():
        setattr(collectives, k, wrap(fn))

    def undo():
        for k, fn in saved.items():
            setattr(collectives, k, fn)
    return undo


def recorded_selections():
    """Record every `top_indices` of the DQ decoder: (scores, selection)
    pairs on the host; returns (list, undo)."""
    from mvgformer_tpu_torch.models import decoder

    taken, original = [], decoder.top_indices

    def recording(scores, k):
        sel = original(scores, k)
        taken.append((scores.float().cpu(), sel.cpu()))
        return sel

    decoder.top_indices = recording

    def undo():
        decoder.top_indices = original
    return taken, undo


def b1_launches_by_lq():
    """B1's launches per Lq (the queries of each call) while a path runs:
    ({Lq: launches}, undo). Each call adds what it added to the wrapper's
    own count, `deform_sample.launches`."""
    from mvgformer_tpu_torch.ops import projattn

    by_lq, original = collections.Counter(), projattn.deform_sample

    def counted(value, spatial_shapes, sampling_locations, *args):
        before = deform_attn.deform_sample.launches
        out = original(value, spatial_shapes, sampling_locations, *args)
        by_lq[sampling_locations.shape[1]] += (
            deform_attn.deform_sample.launches - before)
        return out

    projattn.deform_sample = counted

    def undo():
        projattn.deform_sample = original
    return by_lq, undo


def vp_serve_run(cfg, model, batch, plan, grid, device, timed):
    """One served frame of `model` on `batch` (this rank's views under
    `grid`): the last layer's logits and 3D, the top-K selections and the
    kernel launches (B1's also per Lq); with `timed`, VP_FRAMES frames
    through the eval step (VP_WARMUP warm-up) with the view collectives
    timed."""
    from mvgformer_tpu_torch.core.infer import make_eval_step
    from mvgformer_tpu_torch.models import is_dq
    from mvgformer_tpu_torch.parallel import collectives
    from mvgformer_tpu_torch.utils.profiling import synchronize

    taken, undo = recorded_selections()
    by_lq, undo_b1 = b1_launches_by_lq()
    count_kernels()
    try:
        with torch.inference_mode():
            outs = (model(batch, threshold=THRESHOLD, window_plan=plan,
                          grid=grid) if is_dq(cfg) else
                    model(batch, grid=grid))
        synchronize(device)
    finally:
        undo_b1()
        undo()
    out = {"logits": outs[-1]["pred_logits"].float().cpu(),
           "poses": outs[-1]["pred_poses"].float().cpu(),
           "layer_poses": [o["pred_poses"].float().cpu() for o in outs],
           "selections": taken,
           "launches": {fn.__name__: fn.launches for fn in ALL_KERNELS},
           "b1_by_lq": dict(by_lq)}
    if not timed:
        return out
    step = make_eval_step(cfg, model, THRESHOLD, window_plan=plan, dp=grid)
    for _ in range(VP_WARMUP):
        step(batch)
    synchronize(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    timer = Stopwatch(device)
    undo = timed_collectives(timer, device)
    count_kernels()
    collectives.reset_counts()
    try:
        for _ in range(VP_FRAMES - VP_WARMUP):
            with timer.stage("frame"):
                step(batch)
    finally:
        undo()
    frames = VP_FRAMES - VP_WARMUP
    out["timing"] = {
        "frames_per_s": frames / timer.totals["frame"],
        "frame_ms": 1e3 * timer.totals["frame"] / frames,
        "collectives_ms_per_frame":
            1e3 * timer.totals["collectives"] / frames,
        "collectives_per_frame": sum(collectives.COUNTS.values()) / frames,
        "collectives_share": timer.totals["collectives"]
        / timer.totals["frame"],
        "b1_launches_per_frame": deform_attn.deform_sample.launches / frames,
        "peak_mem_gib": bench.peak_gib(device)}
    return out


def vp_serve_worker(dp, cfgs, out_dir):
    """Phase 23a, 23b and 23d on one rank: each served config's model
    (`cfgs`, name -> config) from SEED, the frame cut to this rank's
    views, `vp_serve_run`; the results to <out_dir>/rank<r>.pt."""
    from mvgformer_tpu_torch.device import strict_float32
    from mvgformer_tpu_torch.models import build_model
    from mvgformer_tpu_torch.models.mvgformer import build_layer1_window_plan
    from mvgformer_tpu_torch.parallel import shard_batch

    strict_float32()
    results = {}
    for name, cfg in cfgs.items():
        model = build_model(cfg, generator=torch.Generator().manual_seed(
            SEED), device=dp.device)
        frame = vp_frame(cfg, dp.device)
        plan = (build_layer1_window_plan(cfg, frame.view_data,
                                         device=dp.device)
                if cfg.DECODER.layer1_windowed_sampling else None)
        results[name] = vp_serve_run(cfg, model, shard_batch(frame, dp),
                                     plan, dp, dp.device,
                                     timed=name == "dq_bf16")
        del model
        bench.empty_cache(dp.device)
    torch.save(results, Path(out_dir) / f"rank{dp.rank}.pt")
    return None


def vp_train_worker(dp, cfgs, out_dir):
    """Phase 23c on one rank: the flagship training step (`cfgs`, dtype ->
    config: gt match, Jacobi, remat, dropout 0) on this rank's views of
    one frame, in float32 and bf16 (its metrics, reduced gradients and
    updated parameters), then VP_STEPS timed bf16 steps with the view
    collectives and the gradient all-reduce timed; to
    <out_dir>/rank<r>.pt."""
    from mvgformer_tpu_torch.core import train as core_train
    from mvgformer_tpu_torch.device import strict_float32
    from mvgformer_tpu_torch.models.mvgformer import MVGFormer
    from mvgformer_tpu_torch.parallel import shard_batch

    strict_float32()
    out = {}
    for dtype, cfg in cfgs.items():
        model = MVGFormer(cfg, generator=torch.Generator().manual_seed(SEED),
                          device=dp.device)
        local = shard_batch(vp_frame(cfg, dp.device), dp)
        state, tx = core_train.create_train_state(cfg, model)
        step = core_train.make_train_step(cfg, model, tx, dp=dp)
        # the ranks of a data row draw the same dropout masks
        gen = torch.Generator().manual_seed(cfg.TRAIN.SEED + dp.data_rank)
        state, metrics = step(state, local, gen)
        out[dtype] = {
            "metrics": {k: v.item() for k, v in metrics.items()},
            "grads": {k: p.grad.float().cpu()
                      for k, p in model.named_parameters()
                      if p.grad is not None},
            "params": {k: p.detach().cpu()
                       for k, p in model.named_parameters()}}
        if dtype == "bfloat16":
            timer = Stopwatch(dp.device)
            undo = timed_collectives(timer, dp.device)
            reduce = core_train.all_reduce_grads
            core_train.all_reduce_grads = functools.partial(
                timer.time_fn, "collectives", reduce)
            count_kernels()
            try:
                for _ in range(VP_STEPS):
                    with timer.stage("step"):
                        state, _ = step(state, local, gen)
            finally:
                core_train.all_reduce_grads = reduce
                undo()
            out["timing"] = {
                "steps_per_s": VP_STEPS / timer.totals["step"],
                "step_ms": 1e3 * timer.totals["step"] / VP_STEPS,
                "collectives_ms_per_step":
                    1e3 * timer.totals["collectives"] / VP_STEPS,
                "collectives_share": timer.totals["collectives"]
                / timer.totals["step"],
                "launches_per_step": {fn.__name__: fn.launches / VP_STEPS
                                      for fn in TRAIN_KERNELS},
                "peak_mem_gib": bench.peak_gib(dp.device)}
        del model, state
        bench.empty_cache(dp.device)
    torch.save(out, Path(out_dir) / f"rank{dp.rank}.pt")
    return None


def vp_single_train(cfg, device):
    """One process's training step of `cfg` on the whole frame: its loss
    terms and gradients."""
    from mvgformer_tpu_torch.core.train import (create_train_state,
                                                make_train_step)
    from mvgformer_tpu_torch.models.mvgformer import MVGFormer

    model = MVGFormer(cfg, generator=torch.Generator().manual_seed(SEED),
                      device=device)
    state, tx = create_train_state(cfg, model)
    _, metrics = make_train_step(cfg, model, tx)(state,
                                                 vp_frame(cfg, device))
    losses = {k: metrics[k].item() for k in DP_LOSSES}
    grads = {k: p.grad.float() for k, p in model.named_parameters()
             if p.grad is not None}
    del model, state
    bench.empty_cache(device)
    return losses, grads


def compare_selections(name, ranks, want):
    """The top-K selections: equal on every rank (a hard gate) and, as
    sets, to one process, where the one allowed difference is a near-tie
    at the K-th score (within VP_TIE relative) that another sum order
    flips. Returns
    (equal to one process, the near-ties, the queries both keep or None
    for all)."""
    first = ranks[0]["selections"]
    for r, res in enumerate(ranks[1:], 1):
        if len(res["selections"]) != len(first) or not all(
                torch.equal(a[1], b[1]) for a, b in
                zip(res["selections"], first)):
            fail(f"{name}: rank {r} selected other top-K queries than "
                 f"rank 0")
    if len(first) != len(want["selections"]):
        fail(f"{name}: {len(first)} compactions, one process "
             f"{len(want['selections'])}")
    if not first:
        return True, [], None
    ties = []
    for (scores, sel), (w_scores, w_sel) in zip(first, want["selections"]):
        # the same queries; their order follows the scores' last bits
        if torch.equal(torch.sort(sel).values, torch.sort(w_sel).values):
            continue
        k = sel.shape[1]
        top = torch.sort(w_scores, dim=1, descending=True).values
        kth, nxt = top[:, k - 1], top[:, k]
        rel = ((kth - nxt).abs() / kth.abs().clamp(min=1e-12)).max().item()
        ties.append({"kth_gap_rel": rel,
                     "differ": int((torch.sort(sel).values
                                    != torch.sort(w_sel).values).sum())})
    # the queries both runs keep after the last compaction
    sel, w_sel = first[-1][1], want["selections"][-1][1]
    keep = [sorted(set(a.tolist()) & set(b.tolist()))
            for a, b in zip(sel, w_sel)]
    return not ties, ties, keep


def bounds_flips(got, want, view_data):
    """The tokens whose projection into some view lies in the image in
    one run and outside it in the other, at the input of a layer after
    the first (the previous layer's 3D, `layer_poses`). The bounds mask
    that zeroes a view's features is a discrete branch there, which the
    runs' last bits can take apart. Returns ((B, Q*J) bool, a list of
    {batch, token, layer, view, edge_px}): edge_px is the distance in
    pixels of the token's projection from the nearest image edge in each
    run (float64), the witness that the token lies on the edge."""
    from mvgformer_tpu_torch.data.meta import map_tensors
    from mvgformer_tpu_torch.geometry.cameras import project_points

    wh = view_data.centers.cpu() * 2.0  # (B, V, 2)
    V = wh.shape[1]

    def project(poses, dtype):
        cams = map_tensors(view_data.cameras, lambda t: t.to(dtype).cpu())
        B, N, _ = poses.shape
        return project_points(poses.to(dtype)[:, None].expand(B, V, N, 3),
                              cams)

    def inside(pix):
        w = wh.to(pix.dtype)
        return ((pix[..., 0] >= 0) & (pix[..., 1] >= 0)
                & (pix[..., 0] < w[..., 0:1]) & (pix[..., 1] < w[..., 1:2]))

    def edge_px(pix):
        w = wh.to(pix.dtype)
        return torch.stack([pix[..., 0].abs(), pix[..., 1].abs(),
                            (pix[..., 0] - w[..., 0:1]).abs(),
                            (pix[..., 1] - w[..., 1:2]).abs()]).amin(dim=0)

    flips = torch.zeros(want[0].shape[:2], dtype=torch.bool)
    where = []
    for layer, (g, w) in enumerate(zip(got[:-1], want[:-1]), start=1):
        flip = inside(project(g, torch.float32)) != inside(
            project(w, torch.float32))  # (B, V, N)
        dg, dw = (edge_px(project(x, torch.float64)) for x in (g, w))
        for b, v, n in flip.nonzero().tolist():
            where.append({"batch": b, "token": n, "layer": layer, "view": v,
                          "edge_px": [dg[b, v, n].item(),
                                      dw[b, v, n].item()]})
        flips |= flip.any(dim=1)
    return flips, where


def compare_served(name, ranks, want, view_data, rel_bound, card,
                   **fields):
    """A served frame on the grid's ranks against one process: top-K
    (`compare_selections`), and over the queries both keep the last
    layer's logits and 3D: in float32 (rel_bound None) at the golden
    classes (logits rtol 1e-3 / atol 2e-3, 3D p99 < 2 mm, max < 6 mm);
    in bf16 (rel_bound, BF16_SERVE_BOUND) within its bounds of the
    largest logit and the largest 3D coordinate. Tokens where the two
    runs' bounds masks part (`bounds_flips`: at most VP_MAX_FLIPS per
    rank, each within VP_EDGE_PX of the edge in both runs) are printed
    with their gap and left out, and so are their queries' logits."""
    equal, ties, keep = compare_selections(name, ranks, want)
    if ties and (rel_bound is None and any(
            t["kth_gap_rel"] > VP_TIE for t in ties)):
        fail(f"{name}: top-K differs from one process without a near-tie "
             f"at the K-th score: {ties}")
    Q = want["logits"].shape[1]
    J = want["poses"].shape[1] // Q
    worst = {"logits_max_abs_err": 0.0, "poses_mm_p99": 0.0,
             "poses_mm_max": 0.0, "logits_rel": 0.0, "poses_rel": 0.0}
    flipped, flip_sites = [], []
    ok = True
    for r, res in enumerate(ranks):
        flips, where = bounds_flips(res["layer_poses"], want["layer_poses"],
                                    view_data)
        flips = flips.reshape(-1, Q, J)
        ok &= (int(flips.sum()) <= VP_MAX_FLIPS
               and all(max(f["edge_px"]) <= VP_EDGE_PX for f in where))
        if r == 0:
            flip_sites = where
        for b in range(want["logits"].shape[0]):
            q = (torch.arange(Q) if keep is None
                 else torch.tensor(keep[b], dtype=torch.long))
            pg = res["poses"][b].reshape(Q, J, 3)[q]
            pw = want["poses"][b].reshape(Q, J, 3)[q]
            flip = flips[b, q]
            if r == 0:
                flipped += [{"query": int(q[i]), "joint": int(j),
                             "mm": (pg[i, j] - pw[i, j]).abs().max().item()}
                            for i, j in flip.nonzero().tolist()]
            q_same = ~flip.any(dim=1)
            lg, lw = res["logits"][b, q][q_same], want["logits"][b, q][q_same]
            err3d = (pg - pw).abs()[~flip]
            p99 = float(np.percentile(err3d.numpy(), 99))
            lerr = (lg - lw).abs().max().item()
            worst["logits_max_abs_err"] = max(worst["logits_max_abs_err"],
                                              lerr)
            worst["poses_mm_p99"] = max(worst["poses_mm_p99"], p99)
            worst["poses_mm_max"] = max(worst["poses_mm_max"],
                                        err3d.max().item())
            worst["logits_rel"] = max(worst["logits_rel"], lerr / max(
                lw.abs().max().item(), 1e-12))
            worst["poses_rel"] = max(worst["poses_rel"], err3d.max().item()
                                     / max(pw.abs().max().item(), 1e-12))
            finite = bool(torch.isfinite(lg).all() and
                          torch.isfinite(pg).all())
            if rel_bound is None:
                ok &= bool(torch.allclose(lg, lw, rtol=1e-3, atol=2e-3)
                           and p99 < 2.0 and err3d.max().item() < 6.0
                           and finite)
            else:
                ok &= (worst["logits_rel"] <= rel_bound["logits_rel"]
                       and worst["poses_rel"] <= rel_bound["poses_rel"]
                       and finite)
    phase("vp_serve", run=name, ranks=len(ranks),
          topk_equal_to_one_process=equal, near_ties=ties,
          bounds_flips=flipped, bounds_flip_sites=flip_sites,
          compared_queries=None if keep is None else [len(k) for k in keep],
          rel_bound=rel_bound, ok=ok, card=card, **worst, **fields)
    if not ok:
        fail(f"{name}: the {len(ranks)} view ranks disagree with one "
             f"process")


def view_parallel(card, device="cuda", serve_cfgs=None, train_cfgs=None):
    """Phase 23: view parallelism on a (1 x VP_VIEWS) grid, each rank one
    of the flagship frame's 5 views, the ranks sharing cuda:0 over gloo
    (the backend rule; where the machine shows VP_VIEWS cards, the same
    again with a card per rank over NCCL). Against one process on the
    whole frame: 23a the served frame (top-64, point-top-4, Jacobi) in
    float32 (TF32 off) and in bf16, 23b with the windowed layer 1 (impl
    'pallas_dma'), 23d the MvP baseline ('cat_proj'), 23c one training
    step in float32 and bf16 (`vp_train_worker`). Per rank: frames/s,
    the view collectives' ms and share of a frame, B1 launches per frame
    and peak memory (23a bf16); steps/s, the collectives' share and
    B2 / B3 launches per step (23c). Returns {run: {path: per-rank
    launches}}. `device` and the configs (`vp_serve_cfgs`'s names;
    dtype -> training config) let the phase be rehearsed at a toy size on
    the CPU."""
    from mvgformer_tpu_torch.device import strict_float32
    from mvgformer_tpu_torch.models import build_model
    from mvgformer_tpu_torch.models.mvgformer import build_layer1_window_plan
    from mvgformer_tpu_torch.parallel import choose_backend, spawn

    strict_float32()
    serve_cfgs = serve_cfgs or vp_serve_cfgs()
    train_cfgs = train_cfgs or {dtype: dp_train_cfg(dtype)
                                for dtype in ("float32", "bfloat16")}
    single, view_data = {}, {}
    for name, cfg in serve_cfgs.items():
        model = build_model(cfg, generator=torch.Generator().manual_seed(
            SEED), device=device)
        frame = vp_frame(cfg, device)
        view_data[name] = frame.view_data
        plan = (build_layer1_window_plan(cfg, frame.view_data,
                                         device=device)
                if cfg.DECODER.layer1_windowed_sampling else None)
        single[name] = vp_serve_run(cfg, model, frame, plan, None, device,
                                    timed=name == "dq_bf16")
        del model
        bench.empty_cache(device)
    single_train = {dtype: vp_single_train(cfg, device)
                    for dtype, cfg in train_cfgs.items()}
    phase("vp_one_process", dtype="bfloat16", **single["dq_bf16"]["timing"],
          card=card)
    launches = {}
    cards = torch.cuda.device_count()
    runs = ((("one_card", 1), ("five_cards", VP_VIEWS))
            if torch.device(device).type == "cuda" else (("cpu", 0),))
    for run, visible in runs:
        if cards < visible:
            phase("vp", run=run, skipped=f"NCCL skipped: {cards} card(s) "
                  f"visible, {VP_VIEWS} needed", card=card)
            continue
        backend = choose_backend(torch.device(device).type, VP_VIEWS,
                                 visible)
        with visible_devices(visible):
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(prefix="vp-",
                                             dir=REPO / "build") as out:
                spawn(vp_serve_worker, VP_VIEWS, device, serve_cfgs, out,
                      views=VP_VIEWS)
                served = [torch.load(Path(out) / f"rank{r}.pt")
                          for r in range(VP_VIEWS)]
            serve_s = time.perf_counter() - t0
            with tempfile.TemporaryDirectory(prefix="vp-",
                                             dir=REPO / "build") as out:
                spawn(vp_train_worker, VP_VIEWS, device, train_cfgs, out,
                      views=VP_VIEWS)
                trained = [torch.load(Path(out) / f"rank{r}.pt")
                           for r in range(VP_VIEWS)]
            train_s = time.perf_counter() - t0 - serve_s
        for name in serve_cfgs:
            compare_served(
                name, [res[name] for res in served], single[name],
                view_data[name],
                BF16_SERVE_BOUND if "bf16" in name else None, card,
                grid=f"1x{VP_VIEWS}", backend=backend, run_on=run,
                launches_per_rank=[res[name]["launches"] for res in served])
        on_card = torch.device(device).type == "cuda"
        for name, kernel in (("dq_f32", deform_attn.deform_sample),
                             ("dq_windowed_f32", window_dma.window_block_dma),
                             ("mvp_f32", deform_attn.deform_sample)):
            if on_card and any(res[name]["launches"][kernel.__name__] == 0
                   for res in served):
                fail(f"{name}: a view rank never launched {kernel.__name__}")
        phase("vp_serve_timing", run=run, backend=backend, dtype="bfloat16",
              per_rank=[res["dq_bf16"]["timing"] for res in served],
              group_frames_per_s=min(res["dq_bf16"]["timing"]["frames_per_s"]
                                     for res in served),
              one_process=single["dq_bf16"]["timing"], seconds=serve_s,
              card=card)
        for dtype, loss_tol in (("float32", 1e-3), ("bfloat16", 2e-2)):
            want_losses, want_grads = single_train[dtype]
            grad_tol, rounding = ((F32_GRAD_BOUND, None)
                                  if dtype == "float32" else
                                  bf16_grad_bounds(
                                      want_grads,
                                      single_train["float32"][1]))
            ranks = [t[dtype] for t in trained]
            loss_gap = max(abs(ranks[0]["metrics"][k] - v)
                           / max(abs(v), 1e-6)
                           for k, v in want_losses.items())
            got = {k: g.to(device) for k, g in ranks[0]["grads"].items()}
            grad_ok, grad_err, worst, bound_share, over = grad_check(
                got, want_grads, grad_tol)
            params_equal = all(
                torch.equal(p, other["params"][k]) for other in ranks[1:]
                for k, p in ranks[0]["params"].items())
            ok = loss_gap <= loss_tol and grad_ok and params_equal
            phase("vp_train", run=run, backend=backend, dtype=dtype,
                  grid=f"1x{VP_VIEWS}", loss_max_rel_gap=loss_gap,
                  loss_tol=loss_tol, grad_max_rel_gap=grad_err,
                  worst_grad=worst,
                  **grad_bound_fields(grad_tol, rounding, worst,
                                      bound_share, over),
                  params_equal_on_ranks=params_equal,
                  losses={k: ranks[0]["metrics"][k] for k in DP_LOSSES},
                  single_process_losses=want_losses, ok=ok, card=card)
            if not ok:
                fail(f"the {VP_VIEWS} view ranks' training step ({dtype}, "
                     f"{run}) disagrees with one process")
        want = {fn.__name__: n for fn, n in zip(TRAIN_KERNELS, (24, 24, 12))}
        timing = [t["timing"] for t in trained]
        if on_card and any(t["launches_per_step"] != want for t in timing):
            fail(f"B2 / B3 launches per step per view rank "
                 f"{[t['launches_per_step'] for t in timing]}, expected "
                 f"{want}")
        phase("vp_train_timing", run=run, backend=backend, dtype="bfloat16",
              per_rank=timing, seconds=train_s, card=card)
        launches[run] = {
            "serve": [res["dq_bf16"]["launches"] for res in served],
            "serve_b1_by_lq": [res["dq_bf16"]["b1_by_lq"]
                               for res in served],
            "serve_windowed": [res["dq_windowed_f32"]["launches"]
                               for res in served],
            "mvp_serve": [res["mvp_f32"]["launches"] for res in served],
            "train_per_step": [t["launches_per_step"] for t in timing]}
    return launches


def check_kernel_one_view(card):
    """B1 at the view-local shapes of phase 23 (one view and one frame per
    rank: N 1, Lq 15360 and 960, P 4), bfloat16 and float32, against its
    plain version on the card. Returns, per Lq in bfloat16, ms, device_ms,
    plain ms and the compulsory work."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    timed = {}
    for Lq in (15360, 960):
        for dtype in (torch.float32, torch.bfloat16):
            value, loc, aw = sampling_inputs(Lq, 4, dtype, gen, views=1)
            out = deform_attn.deform_sample(value, SPATIAL_SHAPES, loc, aw)
            ref = sampling.deform_sample(value.float(), SPATIAL_SHAPES, loc,
                                         aw.float())
            err = (out.float() - ref).abs().max().item()
            ok = (err <= 1e-4 if dtype == torch.float32 else
                  torch.allclose(out.float(), ref, atol=2e-2, rtol=2e-2))
            phase("kernel_vs_plain_one_view", N=1, Lq=Lq, H=HEADS,
                  D=HEAD_DIM, L=len(SPATIAL_SHAPES), P=4, dtype=str(dtype),
                  max_abs_err=err, ok=bool(ok), card=card)
            if not ok:
                fail(f"B1 disagrees with its plain version at one view: "
                     f"Lq={Lq} {dtype} max abs err {err}")
            if dtype == torch.bfloat16:
                def kernel():
                    return deform_attn.deform_sample(value, SPATIAL_SHAPES,
                                                     loc, aw)

                timed[Lq] = {
                    "ms": cuda_ms(kernel), "device_ms": device_ms(kernel)[0],
                    "plain_ms": cuda_ms(lambda: sampling.deform_sample(
                        value, SPATIAL_SHAPES, loc, aw)),
                    "work": bounds.deform_sample(value, SPATIAL_SHAPES, loc,
                                                 aw)}
    return timed


# phase 24: configs/synthetic_ap_ablation.yaml's widths (d_model 128 over
# 8 heads: head dim 16; 8 points; 480x256 images, levels 64x120, 32x60,
# 16x30) and the root tools the port carries (mvgformer_tpu_torch/tools/)
ABL_LEVELS = ((64, 120), (32, 60), (16, 30))
ABL_HEAD_DIM = 16
# B1 in the eval rows: dense layers (Lq 1024 x 15) at P 8 and under
# point-top-4, the layers after top-K 128 and 64 at P 8 and 4
ABL_B1_SHAPES = ((15360, 8), (15360, 4), (1920, 8), (960, 8), (960, 4))
ABL_WINDOW_CLAMP = 4.0  # the windowed rows' layer1_offset_clamp
ABLATION_AT = {
    "build_corner_table": "bfloat16 N=5 H=8 D=16, the 3 ablation levels "
                          "summed",
    "gather_reduce_forward": "bfloat16 NH=40 S=122880 D=16 per level, the "
                             "3 ablation levels summed",
    "gather_reduce_backward": "bfloat16 NH=40 S=122880 D=16 per level, the "
                              "3 ablation levels summed",
    "window_block_matmul": "bfloat16 layer-1 plan of the ablation rig, "
                           "clamp 4, H=8 D=16 P=8, the 3 levels summed",
    "window_block_dma": "bfloat16 layer-1 plan of the ablation rig, clamp "
                        "4, H=8 D=16 P=8, the 3 levels summed"}
TOOL_FRAMES = 8
TOOL_TRAIN_ARGS = (f"DATASET.MAX_DATA_NUM={TOOL_FRAMES}", "TRAIN.END_EPOCH=2")
TOOL_EVAL_ROWS = (("jacobi_dense", "jacobi_dense", ()),
                  ("jacobi_k64_ptop4", "jacobi_k64_ptop4", ()),
                  ("jacobi_k128_clamp4_windowed",
                   "jacobi_k128_clamp4_windowed", ()),
                  ("jacobi_k128_clamp4_windowed_dma",
                   "jacobi_k128_clamp4_windowed",
                   ("DECODER.layer1_window_impl=pallas_dma",)))
PANOPTIC_FILES = 13  # validation interval 12: frames 0 and 12


def ablation_cfg(*overrides):
    from mvgformer_tpu_torch.config import load_config

    return load_config(str(ABLATION_CFG), list(overrides))


def ablation_b1(card, gen):
    """24a, B1 at ABL_B1_SHAPES: float32 within 1e-4 and bfloat16 within
    2e-2 of the plain version, two launches the same bits, the vector
    instance; bfloat16 timed. Returns {(Lq, P): stats}."""
    out_stats = {}
    for Lq, P in ABL_B1_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            value, loc, aw = sampling_inputs(Lq, P, dtype, gen,
                                             levels=ABL_LEVELS,
                                             head_dim=ABL_HEAD_DIM)

            def kernel():
                return deform_attn.deform_sample(value, ABL_LEVELS, loc, aw)

            out = kernel()
            same = torch.equal(out, kernel())
            ref = sampling.deform_sample(value.float(), ABL_LEVELS, loc,
                                         aw.float())
            err = (out.float() - ref).abs().max().item()
            ok = (err <= 1e-4 if dtype == torch.float32 else
                  torch.allclose(out.float(), ref, atol=2e-2, rtol=2e-2))
            vec = _build.vector_width(ABL_HEAD_DIM, value.element_size(),
                                      value, loc, aw, out)
            fields = {}
            if dtype == torch.bfloat16:
                dev_ms, host_us = device_ms(kernel)
                fields = {"ms": cuda_ms(kernel), "device_ms": dev_ms,
                          "host_us": host_us,
                          "plain_ms": cuda_ms(lambda: sampling.deform_sample(
                              value, ABL_LEVELS, loc, aw), runs=5, warmup=1),
                          "bound_ms": bounds.deform_sample(
                              value, ABL_LEVELS, loc, aw).bound_ms}
                out_stats[(Lq, P)] = fields
            phase("ablation_kernel_vs_plain", kernel="deform_sample", N=5,
                  Lq=Lq, H=HEADS, D=ABL_HEAD_DIM, levels=ABL_LEVELS, P=P,
                  dtype=str(dtype), max_abs_err=err, ok=bool(ok),
                  bit_identical=same, elements_per_thread=vec,
                  vector_instance=vec > 1, **fields, card=card)
            if not (ok and same) or vec == 1:
                fail(f"B1 at D {ABL_HEAD_DIM} Lq {Lq} P {P} {dtype}: err "
                     f"{err}, bit-identical {same}, elements/thread {vec}")
    return out_stats


def ablation_b2(card, gen):
    """24a, B2 on the ablation value's three level views: bit for bit
    against the plain version and between two launches; bfloat16 timed
    (summed over the levels)."""
    len_in = sum(h * w for h, w in ABL_LEVELS)
    for dtype in (torch.float32, torch.bfloat16):
        value = torch.randn(N_VIEWS, len_in, HEADS, ABL_HEAD_DIM,
                            device="cuda", generator=gen).to(dtype)
        views = level_views(value, ABL_LEVELS)
        equal = all(torch.equal(table_build.build_corner_table(v),
                                table_build.build_corner_table_plain(v))
                    for v in views)
        same = all(torch.equal(table_build.build_corner_table(v),
                               table_build.build_corner_table(v))
                   for v in views)
        stats = {
            "ms": sum(cuda_ms(lambda v=v: table_build.build_corner_table(v))
                      for v in views),
            "device_ms": sum(device_ms(
                lambda v=v: table_build.build_corner_table(v))[0]
                for v in views),
            "plain_ms": sum(cuda_ms(
                lambda v=v: table_build.build_corner_table_plain(v),
                runs=5, warmup=1) for v in views),
            "bound_ms": bounds.total([
                bounds.table_build(N_VIEWS * HEADS, h, w, ABL_HEAD_DIM,
                                   value.element_size())
                for h, w in ABL_LEVELS]).bound_ms}
        phase("ablation_kernel_vs_plain", kernel="build_corner_table",
              N=N_VIEWS, H=HEADS, D=ABL_HEAD_DIM, levels=ABL_LEVELS,
              dtype=str(dtype), bitwise_equal=equal, bit_identical=same,
              **stats, card=card)
        if not (equal and same):
            fail(f"B2 at D {ABL_HEAD_DIM} {dtype}: equal {equal}, "
                 f"bit-identical {same}")
    return stats


def ablation_b3(card, gen):
    """24a, B3 forward and backward at one dense training layer of the
    ablation config (40 pairs x 122,880 samples per level, D 16) against
    the plain versions as in phase 10 (check_gather_level), the backward
    twice the same bits; bfloat16 timed, the forward beside F.embedding_bag
    (`library_times`). Returns per kernel its stats."""
    fwd, bwd = (table_gather.gather_reduce_forward,
                table_gather.gather_reduce_backward)
    stats = {fwd: {"max_abs_err": 0.0}, bwd: {"max_abs_err": 0.0}}
    for dtype in (torch.float32, torch.bfloat16):
        value, loc, aw = training_layer_inputs(dtype, gen, ABL_LEVELS,
                                               ABL_HEAD_DIM)
        with torch.no_grad():
            tables, _ = table_build.build_corner_tables(
                value.transpose(1, 2), ABL_LEVELS)
            samples = sampling.corner_samples(ABL_LEVELS, loc, aw, dtype)
        cts = [torch.randn(idx.shape + (ABL_HEAD_DIM,), device="cuda",
                           generator=gen).to(dtype) for idx, _ in samples]
        ok, same, errs = True, True, {fwd: 0.0, bwd: 0.0, "bwd_rel": 0.0}
        for tbl, (idx, w4), ct in zip(tables, samples, cts):
            level_ok, level_errs, level_same = check_gather_level(
                tbl, idx, w4, ct)
            ok &= level_ok
            same &= level_same
            for k, v in level_errs.items():
                errs[k] = max(errs[k], v)
        fwd_args = list(zip(tables, *zip(*samples)))
        bwd_args = list(zip(tables, *zip(*samples), cts))
        vec = table_gather.vector_bytes(tables[0], cts[0])
        timed = {}
        if dtype == torch.bfloat16:
            timed = {
                "fwd_ms": sum(cuda_ms(lambda a=a: fwd(*a)) for a in fwd_args),
                "fwd_device_ms": sum(device_ms(lambda a=a: fwd(*a))[0]
                                     for a in fwd_args),
                "fwd_plain_ms": sum(cuda_ms(
                    lambda a=a: table_gather.deform_gather_reduce_plain(*a),
                    runs=5, warmup=1) for a in fwd_args),
                "fwd_bound_ms": bounds.total([
                    bounds.table_gather_forward(t, i)
                    for t, (i, _) in zip(tables, samples)]).bound_ms,
                # F.embedding_bag, held against the plain version first
                "fwd_library_ms": library_times(
                    tables, samples, cts)["library_fwd_ms"],
                "bwd_ms": sum(cuda_ms(lambda a=a: bwd(*a)) for a in bwd_args),
                "bwd_device_ms": sum(device_ms(lambda a=a: bwd(*a))[0]
                                     for a in bwd_args),
                "bwd_plain_ms": sum(cuda_ms(
                    lambda a=a: table_gather.gather_reduce_backward_plain(
                        *a), runs=5, warmup=1) for a in bwd_args),
                "bwd_bound_ms": bounds.total([
                    bounds.table_gather_backward(t, i)
                    for t, (i, _) in zip(tables, samples)]).bound_ms}
            for fn, key in ((fwd, "fwd"), (bwd, "bwd")):
                stats[fn].update({k[len(key) + 1:]: v for k, v in
                                  timed.items() if k.startswith(key)})
        else:
            stats[fwd]["max_abs_err"] = errs[fwd]
            stats[bwd]["max_abs_err"] = errs[bwd]
        phase("ablation_kernel_vs_plain", kernel="gather_reduce",
              NH=N_VIEWS * HEADS, S_per_level=TRAIN_LQ * TRAIN_P,
              D=ABL_HEAD_DIM, table_rows=[t.shape[1] for t in tables],
              dtype=str(dtype), fwd_max_abs_err=errs[fwd],
              bwd_max_abs_err=errs[bwd],
              bwd_max_err_per_max_grad=errs["bwd_rel"],
              bwd_bit_identical=same, vector_bytes=vec, ok=bool(ok),
              **timed, card=card)
        if not (ok and same):
            fail(f"B3 at D {ABL_HEAD_DIM} {dtype}: ok {ok}, backward "
                 f"bit-identical {same}")
        del tables, samples, cts, value, loc, aw
        torch.cuda.empty_cache()
    return stats


def ablation_window(card, gen):
    """24a, B4 and B5 on the level operands of the ablation rig's layer-1
    plan under layer1_offset_clamp 4 (the windowed eval rows), P 8 and 4,
    float32 and bfloat16, each level launched twice for the same bits and
    held to its plain version (check_window_level, which also requires the
    vector instance); bfloat16 P 8 timed, summed over the levels."""
    cfg = ablation_cfg("PARALLEL.COMPUTE_DTYPE=float32")
    plan, centers_px = window_setup(ABL_WINDOW_CLAMP, cfg)
    stats = {fn: {"max_abs_err": 0.0} for fn in PLAIN}
    for P in (8, 4):
        for dtype in (torch.float32, torch.bfloat16):
            value, loc, aw = window_inputs(centers_px, plan.halo, P, dtype,
                                           gen, escape=True,
                                           levels=ABL_LEVELS, heads=HEADS,
                                           head_dim=ABL_HEAD_DIM)
            lines = {}
            for impl, kernel in IMPL_KERNEL.items():
                calls = window_sampling.level_calls(value, ABL_LEVELS, loc,
                                                    aw, plan, impl=impl)
                levels = [check_window_level(kernel, call, dtype)
                          for call in calls]
                lines[kernel.__name__] = levels
                if not all(lv["ok"] for lv in levels):
                    fail(f"{kernel.__name__} at D {ABL_HEAD_DIM} P {P} "
                         f"{dtype} disagrees: {levels}")
                if dtype == torch.float32:
                    stats[kernel]["max_abs_err"] = max(
                        stats[kernel]["max_abs_err"],
                        *(lv["max_abs_err"] for lv in levels))
                elif P == 8:
                    stats[kernel].update(
                        ms=sum(lv["ms"] for lv in levels),
                        device_ms=sum(lv["device_ms"] for lv in levels),
                        plain_ms=sum(lv["plain_ms"] for lv in levels),
                        bound_ms=bounds.total([
                            WINDOW_WORK[kernel](*c.args, **c.kwargs)
                            for c in calls]).bound_ms)
            phase("ablation_kernel_vs_plain", kernel="window", K=plan.levels[
                0].K, Kx=plan.levels[0].Kx, halo=plan.halo, P=P,
                  D=ABL_HEAD_DIM, dtype=str(dtype), kernels=lines,
                  vector_instance=True, card=card)
    return stats


def ablation_kernels(card):
    """Phase 24a: every kernel of the ablation config's paths held against
    its plain version on the card at its shapes (D 16)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    stats = {"deform_sample": ablation_b1(card, gen),
             "build_corner_table": ablation_b2(card, gen)}
    for fn, st in ablation_b3(card, gen).items():
        stats[fn.__name__] = st
    for fn, st in ablation_window(card, gen).items():
        stats[fn.__name__] = st
    torch.cuda.empty_cache()
    return stats


@contextlib.contextmanager
def counted_syncs(into):
    """core.train.make_train_step wrapped so that each step appends to
    `into` the number of synchronizing CUDA operations it made
    (`utils/profiling.py::count_syncs`)."""
    from mvgformer_tpu_torch.core import train as core_train

    real = core_train.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def counted(*a, **k):
            out, syncs = profiling.count_syncs(step, *a, **k)
            into.append(syncs)
            return out
        return counted

    core_train.make_train_step = make
    try:
        yield
    finally:
        core_train.make_train_step = real


def tool_train(card, out_dir):
    """Phase 24b: `python -m mvgformer_tpu_torch.tools.ap_train_fast` (its
    main, in this process) on the ablation config at its full width,
    TOOL_TRAIN_ARGS: 8 frames staged on the card, 2 epochs, 16 steps, then
    --resume to END_EPOCH 3, which must start at epoch 2. Every step is
    counted under the sync debug mode: after the first step of a run (which
    makes the cached constants) none may synchronize. B2 / B3 launch 24 /
    24 / 12 times per step. Returns the checkpoint directory and the launch
    counts."""
    from mvgformer_tpu_torch.tools import ap_train_fast

    cfg = ablation_cfg(*TOOL_TRAIN_ARGS)
    L, layers = len(ABL_LEVELS), cfg.DECODER.num_decoder_layers
    remat = 2 if cfg.PARALLEL.REMAT_DECODER else 1
    per_step = {"build_corner_table": remat * L * layers,
                "gather_reduce_forward": remat * L * layers,
                "gather_reduce_backward": L * layers}
    runs = {}
    for name, extra in (("train", ()),
                        ("resume", ("--resume", "TRAIN.END_EPOCH=3"))):
        syncs = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        count_kernels()
        with counted_syncs(syncs), kept_signal_handlers():
            result = ap_train_fast.main(["--out", out_dir, "--device", "cuda",
                                         *TOOL_TRAIN_ARGS, *extra])
        launches = {fn.__name__: fn.launches for fn in ALL_KERNELS}
        steps = result["steps"]
        want = {k: n * steps for k, n in per_step.items()}
        bad = {k: (launches[k], n) for k, n in want.items()
               if launches[k] != n}
        epochs = result["epochs"]
        runs[name] = launches
        phase("tool_ap_train_fast", run=name,
              tool="mvgformer_tpu_torch.tools.ap_train_fast",
              args=list(TOOL_TRAIN_ARGS) + list(extra),
              start_epoch=result["start_epoch"],
              last_epoch=result["last_epoch"], steps=steps,
              seconds=result["seconds"],
              steps_per_s=steps / result["seconds"],
              steps_per_s_last_epoch=TOOL_FRAMES / epochs[-1]["wall_s"],
              syncs_per_step=syncs, epochs=epochs,
              peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
              kernel_launches=launches, launches_per_step=per_step,
              card=card)
        if bad:
            fail(f"ap_train_fast {name}: launches (got, want) {bad}")
        if len(syncs) != steps or any(syncs[1:]):
            fail(f"ap_train_fast {name}: synchronizing operations per step "
                 f"{syncs}")
        if not all(math.isfinite(v) for line in epochs for k, v in
                   line.items() if k != "epoch"):
            fail(f"ap_train_fast {name}: non-finite metrics {epochs}")
        if name == "resume" and (result["start_epoch"], result["last_epoch"]
                                 ) != (2, 2):
            fail(f"--resume ran epochs {result['start_epoch']}-"
                 f"{result['last_epoch']}, expected 2-2")
    return result["ckpt_dir"], runs


def tool_eval(card, out_dir):
    """Phase 24c: the port's ap_ablation evaluation (`eval_config`, the
    validate CLI `python -m mvgformer_tpu_torch.run.validate` in a
    subprocess on the card) on 24b's checkpoint over TOOL_EVAL_ROWS, the
    eval split cut to 8 frames; every row parsed with its frames/s and the
    CLI's own kernel counts (B1 in every row, B4 in the windowed row, B5
    in the 'pallas_dma' one); then ap_spread_report on those rows."""
    from mvgformer_tpu_torch.tools import ap_ablation, ap_spread_report

    matrix = dict(ap_ablation.matrix(windowed=True))
    results = str(Path(out_dir) / "rows.jsonl")
    ckpt = ap_ablation.find_checkpoint(out_dir)
    rows = []
    for name, base, extra in TOOL_EVAL_ROWS:
        row = ap_ablation.eval_config(
            name, matrix[base] + list(extra), ckpt, results=results,
            out_dir=out_dir, device="cuda",
            common=(f"DATASET.MAX_DATA_NUM={TOOL_FRAMES}",))
        if row is None or row["frames_per_s"] is None:
            fail(f"ap_ablation row {name} failed or carries no frames/s")
        want = {"deform_sample"}
        if "windowed" in name:
            want.add("window_block_dma" if "dma" in name
                     else "window_block_matmul")
        if not all((row["launches"] or {}).get(k) for k in want):
            fail(f"ap_ablation row {name}: the validate CLI launched "
                 f"{row['launches']}, expected {sorted(want)}")
        rows.append(row)
    phase("tool_ap_ablation_eval", tool="mvgformer_tpu_torch.tools."
          "ap_ablation", rows=rows, card=card)
    band, _ = ap_spread_report.main([results, "--device", "cuda"])
    phase("tool_ap_spread_report", rows=len(rows), band_mm=band, card=card)
    return rows


def tool_bone_lengths(card, out_dir):
    """Phase 24d: extract_bone_lengths on the synthetic dataset of the
    ablation config: 14 finite bone lengths and a (15, 3) T-pose."""
    from mvgformer_tpu_torch.tools import extract_bone_lengths

    lengths, tpose = extract_bone_lengths.main([
        "--cfg", str(ABLATION_CFG), "--device", "cuda", "--out", out_dir,
        "--max_frames", str(TOOL_FRAMES),
        f"DATASET.MAX_DATA_NUM={TOOL_FRAMES}"])
    ok = (lengths.shape == (14,) and tpose.shape == (15, 3)
          and np.isfinite(lengths).all() and np.isfinite(tpose).all()
          and (lengths > 0).all())
    phase("tool_extract_bone_lengths", bone_lengths_mm=lengths.tolist(),
          ok=bool(ok), card=card)
    if not ok:
        fail("extract_bone_lengths gave no sane bone lengths")


def have_cv2() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def write_panoptic_tree(root: Path):
    """A small Panoptic CMU0 validation tree: every validation sequence's
    calibration (the synthetic camera ring), one sequence with
    PANOPTIC_FILES body files of two people, and where cv2 can write them
    the five views' JPEGs of the two frames the validation interval
    keeps."""
    from mvgformer_tpu_torch.data.datasets import (CAM_LIST, PANOPTIC_M,
                                                   PANOPTIC_VAL_SEQS)
    from mvgformer_tpu_torch.data.synthetic import (make_camera_ring,
                                                    make_people)

    cam_list = CAM_LIST["CMU0"][:N_VIEWS]
    cams = make_camera_ring(N_VIEWS, image_size=(1920, 1080))
    entries = []
    for v, (panel, node) in enumerate(cam_list):
        R, T = cams.R[v].double().numpy(), cams.T[v].double().numpy()
        K = np.eye(3)
        K[0, 0], K[1, 1] = cams.f[v].tolist()
        K[0, 2], K[1, 2] = cams.c[v].tolist()
        k, p = cams.k[v].tolist(), cams.p[v].tolist()
        entries.append({"panel": panel, "node": node, "K": K.tolist(),
                        "R": (R @ PANOPTIC_M.T).tolist(),
                        "t": (-(R @ T) / 10.0).reshape(3, 1).tolist(),
                        "distCoef": [k[0], k[1], p[0], p[1], k[2]]})
    people = make_people(2, seed=3)
    bodies = []
    for g, pose in enumerate(people):
        j19 = np.zeros((19, 4))
        j19[:15, :3] = (pose / 10.0) @ PANOPTIC_M.T
        j19[:15, 3] = 1.0
        bodies.append({"id": g, "joints19": j19.reshape(-1).tolist()})
    for seq in PANOPTIC_VAL_SEQS:
        (root / seq / "hdPose3d_stage1_coco19").mkdir(parents=True)
        (root / seq / f"calibration_{seq}.json").write_text(
            json.dumps({"cameras": entries}))
    seq = PANOPTIC_VAL_SEQS[0]
    for i in range(PANOPTIC_FILES):
        (root / seq / "hdPose3d_stage1_coco19" /
         f"body3DScene_{i:08d}.json").write_text(
            json.dumps({"bodies": bodies}))
    if not have_cv2():
        return False
    import cv2

    img = np.zeros((1080, 1920, 3), np.uint8)
    img[::64] = 128
    for panel, node in cam_list:
        prefix = f"{panel:02d}_{node:02d}"
        img_dir = root / seq / "hdImgs" / prefix
        img_dir.mkdir(parents=True)
        for i in range(0, PANOPTIC_FILES, 12):
            cv2.imwrite(str(img_dir / f"{prefix}_{i:08d}.jpg"), img)
    return True


def tool_verify(card, out_dir):
    """Phase 24e: verify_checkpoint on a Panoptic tree that this phase
    writes and a checkpoint of configs/panoptic/knn5-lr4-q1024.yaml's model
    with weights drawn from TRAIN.SEED: the port's validate CLI runs on the
    card, and the gate fails (random weights are far from AP25 92.3 / MPJPE
    16.0 mm) with a non-zero exit. Without cv2 the JPEGs can be neither
    written nor read, and the tool must stop at validate's failure, also
    non-zero."""
    from mvgformer_tpu_torch.config import load_config
    from mvgformer_tpu_torch.core.train import OptState, TrainState
    from mvgformer_tpu_torch.models import build_model
    from mvgformer_tpu_torch.tools import verify_checkpoint
    from mvgformer_tpu_torch.utils.checkpoint import save_checkpoint

    root = Path(out_dir) / "panoptic"
    images = write_panoptic_tree(root)
    cfg = load_config(str(FLAGSHIP_CFG))
    model = build_model(cfg, generator=torch.Generator().manual_seed(
        cfg.TRAIN.SEED), device="cuda")
    ckpt = str(Path(out_dir) / "flagship_ckpt")
    zero = torch.zeros((), dtype=torch.int32)
    save_checkpoint(ckpt, TrainState(step=0, model=model, opt_state=OptState(
        count=zero, mu={}, nu={})), 0, next_epoch=1)
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    code = 0
    with contextlib.redirect_stdout(sys.stderr):
        try:
            verify_checkpoint.main(["--model_path", ckpt, "--data_root",
                                    str(root), "--device", "cuda",
                                    "TEST.BATCH_SIZE=1",
                                    f"OUTPUT_DIR={out_dir}"])
        except SystemExit as e:
            code = e.code
    want = ("FIDELITY GATE FAILED" if images else "validate.py failed")
    phase("tool_verify_checkpoint", cv2=images, exit=code,
          gate_failed=isinstance(code, str) and code.startswith(want),
          seconds=time.perf_counter() - t0, card=card)
    if not (isinstance(code, str) and code.startswith(want)):
        fail(f"verify_checkpoint ended with {code!r}, expected {want}")
    print(f"verify_checkpoint: {code}", flush=True)


def tool_host_bench(card):
    """Phase 24f: bench_host_pipeline --frames 8 --threads 1 2 where cv2
    imports (it makes and reads JPEGs); else one line saying so."""
    if not have_cv2():
        print("bench_host_pipeline: cv2 absent on this machine, not run",
              flush=True)
        return
    from mvgformer_tpu_torch.tools import bench_host_pipeline

    summary = bench_host_pipeline.main(["--frames", "8", "--threads", "1",
                                        "2", "--device", "cuda"])
    phase("tool_bench_host_pipeline", summary=summary, card=card)


def tools_phase(card):
    """Phase 24: the ablation config's kernels (24a) and the root tools
    (24b-24f) on the card. Returns the kernels' stats and the launch
    counts of the fast trainer's runs."""
    t0 = time.perf_counter()
    stats = ablation_kernels(card)
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="tools-", dir=REPO / "build") \
            as out_dir:
        _, runs = tool_train(card, out_dir)
        runs = {f"tool_ap_train_fast_{k}": v for k, v in runs.items()}
        for row in tool_eval(card, out_dir):
            runs[f"tool_ap_ablation_{row['config']}"] = row["launches"]
        tool_bone_lengths(card, out_dir)
        tool_verify(card, out_dir)
    tool_host_bench(card)
    phase("tools", seconds=time.perf_counter() - t0, card=card)
    return stats, runs


BENCH_DETAIL_ROWS = (("bench_detail_serve", "topk64_jacobi_ptop4_b1"),
                     ("bench_detail_train", "train_gtmatch_jacobi_b1"))
DRYRUN_RANKS = 4


def bench_phase(card):
    """Phase 25: the port's benches and graft entry on the card, each run
    with the kernel counts set to 0 before it. 25a: `python -m
    mvgformer_tpu_torch.bench` (its main, in this process) at full width:
    its check, the timed frames' checks, syncs per frame, the profiler
    window and peak memory, and the headline line, which must be correct.
    25b: `bench_detail`'s rows topk64_jacobi_ptop4_b1 and
    train_gtmatch_jacobi_b1 (the substring also selects its _chunk8 row, as
    the root script's does); a failed row exits 1. 25c:
    `graft_entry.entry()`'s forward once: the last layer's shapes, finite
    values, B1 once per layer. 25d: `graft_entry.dryrun_multichip`'s
    training and eval step on DRYRUN_RANKS ranks (a 2 x 2 data x view grid)
    sharing the card over gloo: a finite total, a pred row per data rank,
    and on rank 0 (counted there, set to 0 before its steps) B1 once per
    layer and the corner sampler's kernels. Returns the counts of each
    run."""
    from mvgformer_tpu_torch import bench_detail, graft_entry

    t0 = time.perf_counter()
    runs = {}
    headline, runs["bench"] = count_launches(lambda: bench.main([]))
    phase("bench", headline=headline, launches=runs["bench"], card=card)
    for path, row in BENCH_DETAIL_ROWS:
        rows, runs[path] = count_launches(lambda: bench_detail.main([row]))
        phase(path, rows=[r["config"] for r in rows], launches=runs[path],
              card=card)
    bench.empty_cache("cuda")
    forward, args = graft_entry.entry()
    (poses, logits), runs["graft_entry"] = count_launches(
        lambda: forward(*args))
    cfg = bench.flagship_cfg()
    Q, J = cfg.DECODER.num_instance, cfg.DECODER.num_keypoints
    layers = cfg.DECODER.num_decoder_layers
    phase("graft_entry", poses=list(poses.shape), logits=list(logits.shape),
          finite=bool(torch.isfinite(poses).all()
                      and torch.isfinite(logits).all()),
          launches=runs["graft_entry"], card=card)
    if (tuple(poses.shape) != (1, Q * J, 3) or tuple(logits.shape) != (1, Q, 2)
            or not torch.isfinite(poses).all()
            or runs["graft_entry"]["deform_sample"] != layers):
        fail(f"graft_entry's forward: poses {tuple(poses.shape)}, logits "
             f"{tuple(logits.shape)}, launches {runs['graft_entry']}")
    del forward, args, poses, logits
    bench.empty_cache("cuda")
    t_dry = time.perf_counter()
    dry = graft_entry.dryrun_multichip(DRYRUN_RANKS)
    runs["graft_dryrun_rank0"] = dry["launches"]
    cfg = graft_entry.dryrun_cfg(DRYRUN_RANKS)
    rows = graft_entry.dryrun_grid(DRYRUN_RANKS)[0]
    phase("graft_dryrun", ranks=DRYRUN_RANKS, total=dry["total"],
          pred=list(dry["pred"].shape), launches=dry["launches"],
          seconds=time.perf_counter() - t_dry, card=card)
    if (dry["pred"].shape[0] != rows or not np.isfinite(dry["pred"]).all()
            or dry["launches"]["deform_sample"]
            != cfg.DECODER.num_decoder_layers
            or not all(dry["launches"][fn.__name__]
                       for fn in TRAIN_KERNELS)):
        fail(f"graft_entry's dry run: pred {dry['pred'].shape}, launches "
             f"{dry['launches']}")
    phase("benches", seconds=time.perf_counter() - t0, card=card)
    return runs


def lt_cell():
    """The volumetric cell's configuration and traffic."""
    return (json.loads(LT_CONFIG.read_text()),
            json.loads(LT_TRAFFIC.read_text()))


def pelvis_inputs(seed, noise_px=2.0, device="cuda"):
    """`fused_dlt`'s keyword arguments as the volumetric model's pelvis
    stage gives them, at (B 1, N 1, V 4): the cell's rig (its camera ring
    at its `cam_seed`, the full frame as the crop), the base joint of one
    subject placed as the cell's frames place it, projected into the
    network image plus `noise_px` of gaussian noise (the soft-argmax's
    error), zero logits (equal weights) and the mask true."""
    from benchmark import frames
    from mvgformer_tpu_torch.geometry.cameras import (project_points,
                                                      projection_matrices)
    from mvgformer_tpu_torch.geometry.transforms import apply_affine

    spec, traffic = lt_cell()
    s = spec["settings"]
    rig = {k: v[None] for k, v in
           frames.make_rig(spec, traffic, "cpu").items()}
    cams = CameraParams(**{k: rig[k] for k in "RTfckp"})
    V = rig["R"].shape[1]
    rng = np.random.default_rng(seed)
    world = frames.people(1, np.asarray(spec["t_pose"]),
                          s["MULTI_PERSON.SPACE_CENTER"],
                          rng)[:, s["NETWORK.BASE_JOINT"]]
    pix = project_points(
        torch.from_numpy(world)[None, None].expand(1, V, 1, 3), cams)
    net = apply_affine(pix, rig["affine"])  # (1, V, 1, 2)
    net = net + noise_px * torch.from_numpy(
        rng.standard_normal(tuple(net.shape)).astype(np.float32))
    ops = dict(refined=net.transpose(0, 1).contiguous(),
               logits=torch.zeros(V, 1, 1),
               mask=torch.ones(1, 1, dtype=torch.bool),
               inv_affine=rig["inv_affine"],
               proj=projection_matrices(cams, inv_trans=True))
    ops = {k: v.to(device) for k, v in ops.items()}
    ops["cameras"] = CameraParams(**{
        k: getattr(cams, k).to(device) for k in ("R", "T", "f", "c", "k",
                                                 "p")})
    return ops


def lt_step(seed, device="cuda", **settings):
    """The volumetric cell's served step at its configuration (with
    `settings` over it) on weights drawn from `seed`, and two frames of
    its traffic as the port's batches."""
    from benchmark import frames, program, weights

    spec, traffic = lt_cell()
    spec["settings"].update(settings)
    cfg = program.config(spec)
    net = program.model(cfg, device)
    weights.load(net, weights.draw(weights.float_shapes(net), seed, device))
    ring = frames.make_ring(spec, dict(traffic, ring_frames=2), seed, device)
    step = program.eval_step(cfg, net,
                             spec["settings"]["MULTI_PERSON.THRESHOLD"])
    J = len(spec["t_pose"])
    return step, [program.batch(ring.views[i:i + 1].to(device),
                                ring.rig_batch(1), 1, J) for i in range(2)]


def dlt_kernel(card, floor_ms):
    """Phase 26a: the DLT kernel against the plain chain at a served
    layer's shapes, and timed, then at the volumetric cell's pelvis
    shape over DLT_PELVIS_DRAWS subjects. Returns a `by_shape` entry per
    batch, then the pelvis's."""
    center = torch.tensor(DLT_SPACE_CENTER)
    half = torch.tensor([4000.0, 4000.0, 1000.0])
    shapes = []
    for B in DLT_BATCHES:
        ops = dlt_inputs(B, DLT_POINTS, DLT_VIEWS, seed=SEED + B)
        got = dlt_jacobi.fused_dlt(**ops)
        want = dlt_jacobi.plain_dlt(**ops)
        inside = ops["mask"] & ((want - center.cuda()).abs()
                                <= half.cuda()).all(dim=-1)
        gap = (got - want).abs()[inside]
        err = float(gap.max())
        # the card tests' tolerance: 0.05 mm or 1e-5 of the coordinate
        over = int((gap > 0.05 + 1e-5 * want.abs()[inside]).sum())
        fused = functools.partial(dlt_jacobi.fused_dlt, **ops)
        plain = functools.partial(dlt_jacobi.plain_dlt, **ops)
        dev, host = device_ms(fused)
        shapes.append({
            "at": f"float32 B={B} N={DLT_POINTS} V={DLT_VIEWS} (a served "
                  f"layer's top-64 x 15 joints)",
            "max_abs_err_mm": err, "over_tolerance": over,
            "inside": int(inside.sum()),
            "masked_zero": bool((got[~ops["mask"]] == 0).all()),
            "ms": cuda_ms(fused), "device_ms": dev, "host_us": host,
            "plain_ms": cuda_ms(plain, runs=5, warmup=1),
            "floor_ms": floor_ms})
        if over or not shapes[-1]["masked_zero"]:
            fail(f"the DLT kernel at B {B}: {shapes[-1]}")
    draws = [pelvis_inputs(SEED + 2500 + i) for i in range(DLT_PELVIS_DRAWS)]
    errs, over, finite = [], 0, True
    for ops in draws:
        got = dlt_jacobi.fused_dlt(**ops)
        want = dlt_jacobi.plain_dlt(**ops)
        gap = (got - want).abs()
        errs.append(float(gap.max()))
        over += int((gap > 0.05 + 1e-5 * want.abs()).sum())
        finite = finite and bool(torch.isfinite(got).all())
    fused = functools.partial(dlt_jacobi.fused_dlt, **draws[0])
    plain = functools.partial(dlt_jacobi.plain_dlt, **draws[0])
    dev, host = device_ms(fused)
    V = draws[0]["refined"].shape[0]
    shapes.append({
        "at": f"float32 B=1 N=1 V={V} (the volumetric cell's pelvis: zero "
              f"logits, mask true, its rig)",
        "views": V, "draws": DLT_PELVIS_DRAWS, "max_abs_err_mm": max(errs),
        "over_tolerance": over, "finite": finite,
        "ms": cuda_ms(fused), "device_ms": dev, "host_us": host,
        "plain_ms": cuda_ms(plain, runs=5, warmup=1), "floor_ms": floor_ms})
    if over or not finite:
        fail(f"the DLT kernel at the pelvis shape: {shapes[-1]}")
    phase("dlt_kernel", by_shape=shapes,
          ptxas=_build.kernel_report(_build.CSRC / "dlt_jacobi.cu"),
          card=card)
    return shapes


@contextlib.contextmanager
def float32_casts_lifted():
    """The plain chain in its inputs' dtype throughout: its casts to float32
    (`triangulate_dlt`'s and `jacobi4_smallest`'s `.float()`) are the
    identity inside."""
    cast = torch.Tensor.float
    torch.Tensor.float = lambda self: self
    try:
        yield
    finally:
        torch.Tensor.float = cast


def dlt_graph(fn, ops):
    """fn's (B, N, 3) points with the refined points and logits as fresh
    leaves that require grad, and the leaves."""
    leaves = (ops["refined"].detach().clone().requires_grad_(),
              ops["logits"].detach().clone().requires_grad_())
    return fn(**dict(ops, refined=leaves[0], logits=leaves[1])), leaves


def point_errors(got, want, mask):
    """Each kept point's |got - want| / |want| over its views' entries, in
    float64, where `want` is not zero."""
    def rows(t):
        return t.movedim(0, 2).reshape(mask.numel(), -1)[mask.reshape(-1)]
    g, w = rows(got.double()), rows(want.double())
    norm = w.norm(dim=1)
    keep = norm > 0
    return (g - w)[keep].norm(dim=1) / norm[keep]


def dlt_backward(card, floor_ms):
    """Phase 26b: the backward kernel at the training layer's shape against
    autograd through `plain_dlt` on the same inputs and cotangent, both
    held to the float64 gradient (the plain chain with its float32 casts
    lifted): the kernel's error at each quantile of DLT_BWD_QUANTILES
    within DLT_BWD_FACTORS of float32 autograd's, masked points exact
    zeros, kept ones finite. Timed alone (`torch.autograd.grad` on one
    forward's graph) beside the plain chain's autograd backward, and the
    forward at this shape (`forward`) beside the plain chain's."""
    B, N, V = DLT_BWD_SHAPE
    ops = dlt_inputs(B, N, V, seed=SEED + 24)
    grad = torch.randn(B, N, 3, generator=torch.Generator().manual_seed(
        SEED + 24)).cuda()
    backward = profiling.COUNTERS[dlt_jacobi.BACKWARD_COUNTER]
    out, leaves = dlt_graph(dlt_jacobi.fused_dlt, ops)
    got = torch.autograd.grad(out, leaves, grad)
    backward = profiling.COUNTERS[dlt_jacobi.BACKWARD_COUNTER] - backward
    out, leaves = dlt_graph(dlt_jacobi.plain_dlt, ops)
    plain = torch.autograd.grad(out, leaves, grad)
    ops64 = {k: v.double() if v.is_floating_point() else v
             for k, v in ops.items() if k != "cameras"}
    ops64["cameras"] = CameraParams(**{
        name: getattr(ops["cameras"], name).double()
        for name in ("R", "T", "f", "c", "k", "p")})
    with float32_casts_lifted():
        out, leaves = dlt_graph(dlt_jacobi.plain_dlt, ops64)
        truth = torch.autograd.grad(out, leaves, grad.double())
    mask = ops["mask"]
    q = torch.tensor(DLT_BWD_QUANTILES, dtype=torch.float64, device="cuda")
    factors = torch.tensor(DLT_BWD_FACTORS, dtype=torch.float64,
                           device="cuda")
    errors = {}
    for name, g, p, t in zip(("d_refined", "d_logits"), got, plain, truth):
        ours = torch.quantile(point_errors(g, t, mask), q)
        theirs = torch.quantile(point_errors(p, t, mask), q)
        errors[name] = {
            "quantiles": list(DLT_BWD_QUANTILES), "kernel": ours.tolist(),
            "autograd_f32": theirs.tolist(),
            "within": bool((ours <= theirs * factors + 1e-7).all()),
            "masked_zero": bool((g[:, ~mask] == 0).all()),
            "finite": bool(torch.isfinite(g[:, mask]).all())}
    out, leaves = dlt_graph(dlt_jacobi.fused_dlt, ops)
    fused = functools.partial(torch.autograd.grad, out, leaves, grad,
                              retain_graph=True)
    plain_out, plain_leaves = dlt_graph(dlt_jacobi.plain_dlt, ops)
    plain = functools.partial(torch.autograd.grad, plain_out, plain_leaves,
                              grad, retain_graph=True)
    dev, host = device_ms(fused)
    work = bounds.dlt_jacobi_bwd(B, N, V)
    # the forward at this shape as training calls it: leaves that require
    # grad, so each call also records its autograd node (the plain chain
    # its graph)
    fused_fwd = functools.partial(dlt_jacobi.fused_dlt,
                                  **dict(ops, refined=leaves[0],
                                         logits=leaves[1]))
    plain_fwd = functools.partial(dlt_jacobi.plain_dlt,
                                  **dict(ops, refined=plain_leaves[0],
                                         logits=plain_leaves[1]))
    fwd_dev, fwd_host = device_ms(fused_fwd)
    row = {"at": f"float32 B={B} N={N} V={V} (the training layer's 1024 "
                 f"queries x 15 joints)",
           "errors": errors,
           "max_rel_err": errors["d_refined"]["kernel"][-1],
           "backward_launches": backward,
           "ms": cuda_ms(fused), "device_ms": dev, "host_us": host,
           "plain_ms": cuda_ms(plain, runs=5, warmup=1),
           "bound_ms": work.bound_ms, "bound_by": work.bound_by,
           "floor_ms": floor_ms,
           "forward": {"ms": cuda_ms(fused_fwd), "device_ms": fwd_dev,
                       "host_us": fwd_host,
                       "plain_ms": cuda_ms(plain_fwd, runs=5, warmup=1),
                       "bound_ms": bounds.dlt_jacobi(B, N, V).bound_ms}}
    phase("dlt_backward", **row, card=card)
    if backward != 1 or not all(e["within"] and e["masked_zero"]
                                and e["finite"] for e in errors.values()):
        fail(f"the DLT backward kernel: {row}")
    del out, leaves, plain_out, plain_leaves
    return row


def dlt_counts(card):
    """Phase 26c: fused_dlt's counts over one served flagship frame at
    batch 1 and at batch 8, over one flagship training step and over one
    frame of the volumetric cell served at full width, each from 0: a
    launch per layer and no plain call in serving; in training a forward
    launch per layer (again in the remat recompute), a backward launch per
    layer and no plain call; one launch, no plain call and no host
    synchronization in the volumetric step."""
    from mvgformer_tpu_torch.core.infer import make_eval_step
    from mvgformer_tpu_torch.core.train import (create_train_state,
                                                make_train_step)
    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.models.mvgformer import MVGFormer

    cfg = flagship_cfg("bfloat16")
    layers = cfg.DECODER.num_decoder_layers
    model = MVGFormer(cfg, generator=torch.Generator().manual_seed(SEED))
    counts = {}
    for B in DLT_BATCHES:
        frame = make_batch(cfg, batch_size=B, seed=SEED + 300 + B,
                           num_people=3, cam_seed=SEED)
        step = make_eval_step(cfg, model, THRESHOLD)
        dlt_jacobi.fused_dlt.launches = dlt_jacobi.fused_dlt.plain_calls = 0
        step(frame)
        torch.cuda.synchronize()
        counts[f"serve_b{B}"] = (dlt_jacobi.fused_dlt.launches,
                                 dlt_jacobi.fused_dlt.plain_calls)
    state, tx = create_train_state(cfg, model)
    train_step = make_train_step(cfg, model, tx)
    batch = make_batch(cfg, batch_size=1, seed=SEED + 400, num_people=3,
                       cam_seed=SEED)
    dlt_jacobi.fused_dlt.launches = dlt_jacobi.fused_dlt.plain_calls = 0
    backward = profiling.COUNTERS[dlt_jacobi.BACKWARD_COUNTER]
    train_step(state, batch, torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    counts["train"] = (dlt_jacobi.fused_dlt.launches,
                       dlt_jacobi.fused_dlt.plain_calls)
    backward = profiling.COUNTERS[dlt_jacobi.BACKWARD_COUNTER] - backward
    remat = 2 if cfg.PARALLEL.REMAT_DECODER else 1
    del model, state
    torch.cuda.empty_cache()
    step, batches = lt_step(SEED + 25)
    step(batches[0])  # the first call makes the cached constants
    torch.cuda.synchronize()
    dlt_jacobi.fused_dlt.launches = dlt_jacobi.fused_dlt.plain_calls = 0
    pred, lt_syncs = profiling.count_syncs(step, batches[1])
    torch.cuda.synchronize()
    counts["lt_serve_b1"] = (dlt_jacobi.fused_dlt.launches,
                             dlt_jacobi.fused_dlt.plain_calls)
    lt_pred = {"shape": list(pred.shape),
               "finite": bool(torch.isfinite(pred).all())}
    want = {**{f"serve_b{B}": (layers, 0) for B in DLT_BATCHES},
            "train": (remat * layers, 0), "lt_serve_b1": (1, 0)}
    phase("dlt_counts", launches_plain_calls=counts,
          train_backward_launches=backward, lt_syncs=lt_syncs,
          lt_pred=lt_pred,
          engagement={k: (n / (n + p) if n + p else None)
                      for k, (n, p) in counts.items()}, card=card)
    if counts != want or backward != layers:
        fail(f"fused_dlt's counts {counts}, expected {want}; backward "
             f"launches {backward}, expected {layers}")
    if lt_syncs or not lt_pred["finite"]:
        fail(f"the volumetric step: {lt_syncs} syncs, pred {lt_pred}")
    del step, batches, pred
    torch.cuda.empty_cache()
    return counts, backward


def dlt_spans(card):
    """Phase 26d: `python3 -m benchmark.spans` on the two DQ serving cells
    and the volumetric one, each in its own process: `mvg.dlt`'s device
    ops a frame, and where the cell reports them its span metrics
    (`mvg.dlt`'s untraced host ms a frame among them), the traced device
    ops a frame and the idle share."""
    out = {}
    for cell in DLT_SPAN_CELLS:
        proc = subprocess.run(
            [sys.executable, "-m", "benchmark.spans", "--workload", cell,
             "--seed", DLT_SPAN_SEED, "--seconds", DLT_SPAN_SECONDS],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"benchmark.spans on {cell}: {proc.stderr[-2000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        dlt = res["spans"].get("mvg.dlt")
        units = res["traced"]["units"]
        out[cell] = {"dlt_span": dlt,
                     "dlt_ops_per_unit": dlt["ops"] / units if dlt else None,
                     "span_metrics": res["span_metrics"],
                     "metrics": res["metrics"], "correct": res["correct"],
                     "checks": res["checks"], "units": units}
        phase("dlt_spans", cell=cell, **out[cell], card=card)
        if dlt is None:
            fail(f"benchmark.spans on {cell}: no `mvg.dlt` span")
    return out


def dlt_phase(card, floor_ms):
    """Phase 26: the Jacobi DLT kernels (26a-26d). Returns the forward's
    shapes, the backward's row (with its launches in a training step),
    the counts and the spans."""
    t0 = time.perf_counter()
    shapes = dlt_kernel(card, floor_ms)
    backward = dlt_backward(card, floor_ms)
    counts, backward["launches"] = dlt_counts(card)
    spans = dlt_spans(card)
    phase("dlt", seconds=time.perf_counter() - t0, card=card)
    return shapes, backward, counts, spans


def topm_inputs(shape, seed):
    """ProjAttn's operands of point-top-m on the card: weights softmaxed
    over (Lt, P) from normal logits, locations uniform in [0, 1]."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    N, Lq, H, Lt, P = shape
    logits = torch.randn((N, Lq, H, Lt * P), generator=gen, device="cuda")
    weights = torch.softmax(logits, dim=-1).reshape(shape)
    locations = torch.rand(shape + (2,), generator=gen, device="cuda")
    return weights, locations


def topm_kernel(card, floor_ms):
    """Phase 27a: the point-top-m kernel against the plain chain at a
    served frame's two shapes, and timed. Returns a `by_shape` entry per
    shape."""
    shapes = []
    for i, shape in enumerate(TOPM_SHAPES):
        w, loc = topm_inputs(shape, SEED + 500 + i)
        with torch.inference_mode():
            got_w, got_loc = point_topm.point_topm(w, loc, TOPM_M)
            want_w, want_loc = point_topm.plain_point_topm(w, loc, TOPM_M)
        rel = float(((got_w - want_w).abs() / want_w.abs()).max())
        kernel = functools.partial(point_topm.point_topm, w, loc, TOPM_M)
        plain = functools.partial(point_topm.plain_point_topm, w, loc,
                                  TOPM_M)
        with torch.inference_mode():
            dev, host = device_ms(kernel)
            shapes.append({
                "at": f"float32 N={shape[0]} Lq={shape[1]} H={shape[2]} "
                      f"Lt={shape[3]} P={shape[4]} m={TOPM_M}",
                "locations_equal": bool(torch.equal(got_loc, want_loc)),
                "max_rel_err": rel, "ms": cuda_ms(kernel), "device_ms": dev,
                "host_us": host, "plain_ms": cuda_ms(plain, runs=5),
                "bound_ms": bounds.point_topm(*shape, TOPM_M).bound_ms,
                "floor_ms": floor_ms})
        if not shapes[-1]["locations_equal"] or not rel <= TOPM_RTOL:
            fail(f"the point-top-m kernel at {shape}: {shapes[-1]}")
        del w, loc, got_w, got_loc, want_w, want_loc
    phase("point_topm_kernel", by_shape=shapes,
          ptxas=_build.kernel_report(_build.CSRC / "point_topm.cu"),
          card=card)
    return shapes


def topm_counts(card):
    """Phase 27b: `point_topm.launches` over one served flagship frame at
    batch 1 and at batch 8: one launch per decoder layer."""
    from mvgformer_tpu_torch.core.infer import make_eval_step
    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.models.mvgformer import MVGFormer

    cfg = flagship_cfg("bfloat16")
    model = MVGFormer(cfg, generator=torch.Generator().manual_seed(SEED))
    step = make_eval_step(cfg, model, THRESHOLD)
    counts = {}
    for B in DLT_BATCHES:
        frame = make_batch(cfg, batch_size=B, seed=SEED + 600 + B,
                           num_people=3, cam_seed=SEED)
        before = profiling.COUNTERS[point_topm.COUNTER]
        step(frame)
        torch.cuda.synchronize()
        counts[f"serve_b{B}"] = (profiling.COUNTERS[point_topm.COUNTER]
                                 - before)
    want = {f"serve_b{B}": cfg.DECODER.num_decoder_layers
            for B in DLT_BATCHES}
    phase("point_topm_counts", launches=counts, card=card)
    if counts != want:
        fail(f"point_topm's launches {counts}, expected {want}")
    del model, step
    torch.cuda.empty_cache()
    return counts


def topm_phase(card, floor_ms):
    """Phase 27: point-top-m in ProjAttn (27a-27b)."""
    t0 = time.perf_counter()
    shapes = topm_kernel(card, floor_ms)
    counts = topm_counts(card)
    phase("point_topm", seconds=time.perf_counter() - t0, card=card)
    return shapes, counts


def parent_vs_change(card, parent):
    """B1 at B1_SHAPES, B4 and B5 on the K = 28 plan, B2 on the flagship
    value's level views and the table slots' five maps at their two sizes,
    bfloat16, timed by this checkout's
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
    parser.add_argument("--benches-only", action="store_true",
                        help="build the sources, run phase 25 alone (the "
                        "benches and the graft entry) and stop: a reading "
                        "of the benches inside this script, to set beside "
                        "their standalone runs; prints no result line")
    parser.add_argument("--dlt-only", action="store_true",
                        help="build the sources, read the launch floor, "
                        "run phase 26 alone (the serving DLT kernel) and "
                        "stop; prints no result line")
    parser.add_argument("--point-topm-only", action="store_true",
                        help="build the sources, read the launch floor, "
                        "run phase 27 alone (the point-top-m kernel) and "
                        "stop; prints no result line")
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
    if args.benches_only:
        bench_phase(card)
        return
    if args.dlt_only:
        dlt_phase(card, launch_floor(card))
        return
    if args.point_topm_only:
        topm_phase(card, launch_floor(card))
        return

    worst_f32, b1_shapes = check_kernel(card)
    window_stats = check_window_kernels(card)
    check_windowed_slice(card, *check_slice(card))

    cfg = flagship_cfg("bfloat16")
    model = MVGFormer(cfg, generator=torch.Generator().manual_seed(SEED))
    n = max(SERVE_FRAMES, WINDOW_FRAMES)
    frames = [make_batch(cfg, batch_size=1, seed=SEED + 1 + i,
                         num_people=3, cam_seed=SEED) for i in range(n)]
    # B1's launches per Lq: dense layer 1 and the top-64 layers
    b1_by_lq, undo = b1_launches_by_lq()
    try:
        launches = {"deform_sample": serve(
            card, cfg, model, frames[:SERVE_FRAMES])["deform_sample"]}
    finally:
        undo()
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
    floor_ms = launch_floor(card)
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

    t_new = time.perf_counter()
    check_mvp_slice(card)
    mvp_serve_launches, mvp_serve_prof = mvp_serve(card)
    mvp_train_launches, mvp_train_prof = mvp_train(card)
    option_launches, flagship_options = dq_options(card)
    phase("mvp_and_options", seconds=time.perf_counter() - t_new, card=card)

    t_dp = time.perf_counter()
    dp_runs = dp_train(card)
    with tempfile.TemporaryDirectory(prefix="dp-cli-", dir=REPO / "build") \
            as out_dir:
        dp_cli_train(card, out_dir)
        dp_cli_validate(card, out_dir)
        debug_dumps(card, out_dir)
    stage_split(card)
    phase("parallel_debug_stages", seconds=time.perf_counter() - t_dp,
          card=card)
    t_vp = time.perf_counter()
    one_view = check_kernel_one_view(card)
    vp_runs = view_parallel(card)
    # B1's launches per Lq on each view rank's served bf16 frame (ranks
    # sharing one card)
    vp_by_lq = {run: paths.pop("serve_b1_by_lq")
                for run, paths in vp_runs.items()}["one_card"]
    phase("view_parallelism", seconds=time.perf_counter() - t_vp, card=card)
    ablation_stats, tool_runs = tools_phase(card)
    bench_runs = bench_phase(card)
    dlt_shapes, dlt_bwd, dlt_launches, _ = dlt_phase(card, floor_ms)
    topm_shapes, topm_launches = topm_phase(card, floor_ms)
    mvp = {"serve_launches": mvp_serve_launches,
           "b1_device_ms_per_launch":
               mvp_serve_prof["b1_device_ms_per_launch"]}
    path_launches = {
        "dq_serve": {**{k.__name__: 0 for k in ALL_KERNELS}, **launches},
        "dq_train": train_launches, "mvp_serve": mvp_serve_launches,
        "mvp_train": mvp_train_launches, "dq_options_toy": option_launches,
        **{f"flagship_train_{name}": run["launches_per_step"]
           for name, run in flagship_options.items()},
        **{f"dp_train_{name}_rank{s['rank']}_per_step":
           s["launches_per_step"] for name, stats in dp_runs.items()
           for s in stats},
        # phase 23: each path on each view rank, counts set to 0 before it
        **{f"vp_{path}_{run}_rank{r}": counts
           for run, paths in vp_runs.items()
           for path, per_rank in paths.items()
           for r, counts in enumerate(per_rank)},
        # phase 24: the fast trainer's two runs in this process, and each
        # ap_ablation row's validate CLI (its own count, in its process)
        **tool_runs,
        # phase 25: the benches and the graft entry
        **bench_runs}

    turns = (parent_vs_change(card, Path(args.parent).resolve())
             if args.parent else {})
    flagship = "bfloat16 NH=40 S=122880 D=32 per level, the 3 flagship " \
        "levels summed (one training layer)"
    by_shape = [{"at": f"bfloat16 N=5 Lq={Lq} H=8 D=32 L=3 P={P}",
                 "launches": b1_by_lq.get(Lq, 0),
                 "ms": b1_shapes[(Lq, P)]["ms"],
                 "device_ms": b1_shapes[(Lq, P)]["device_ms"],
                 "plain_ms": b1_shapes[(Lq, P)]["plain_ms"],
                 "bound_ms": b1_shapes[(Lq, P)]["work"].bound_ms,
                 **turns.get(f"deform_sample Lq {Lq} P {P}", {})}
                for Lq, P in B1_SHAPES]
    # the MvP baseline serves every layer densely at P 8 (phase 18b)
    mvp_shape = b1_shapes[(MVP_LQ, MVP_P)]
    by_shape.append({
        "at": f"bfloat16 N=5 Lq={MVP_LQ} H=8 D=32 L=3 P={MVP_P} (MvP "
              f"baseline, every layer)",
        "launches": mvp["serve_launches"]["deform_sample"],
        "ms": mvp_shape["ms"], "device_ms": mvp_shape["device_ms"],
        "plain_ms": mvp_shape["plain_ms"],
        "bound_ms": mvp_shape["work"].bound_ms,
        "in_step_device_ms_per_launch": mvp["b1_device_ms_per_launch"]})
    # phase 23: each view rank's served bf16 frame, layer 1 at Lq 15360
    # and the later layers at 960, one view per rank
    for Lq in (15360, 960):
        st = one_view[Lq]
        by_shape.append({
            "at": f"bfloat16 N=1 Lq={Lq} H=8 D=32 L=3 P=4 (one view per "
                  f"rank, phase 23a)",
            "launches": sum(r.get(Lq, 0) for r in vp_by_lq),
            "ms": st["ms"],
            "device_ms": st["device_ms"], "plain_ms": st["plain_ms"],
            "bound_ms": st["work"].bound_ms})
    dense = b1_shapes[B1_SHAPES[0]]
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
            device_ms=st["device_ms"], ms_f32=st["ms_f32"],
            library_ms_f32=st["library_ms_f32"], **extra))
    dlt_rows = [{**sh, "launches": dlt_launches[f"serve_b{B}"][0],
                 "bound_ms": bounds.dlt_jacobi(
                     B, DLT_POINTS, DLT_VIEWS).bound_ms}
                for B, sh in zip(DLT_BATCHES, dlt_shapes)]
    # the volumetric cell's pelvis, a launch a frame
    pelvis = dlt_shapes[len(DLT_BATCHES)]
    dlt_rows.append({**pelvis, "launches": dlt_launches["lt_serve_b1"][0],
                     "bound_ms": bounds.dlt_jacobi(
                         1, 1, pelvis["views"]).bound_ms})
    # a training step's forward launches (the remat recompute's too), with
    # the plain chain's forward as it records its graph
    dlt_rows.append({"at": dlt_bwd["at"], "launches": dlt_launches["train"][0],
                     **dlt_bwd["forward"]})
    kernels.append(kernel_row(
        dlt_jacobi.fused_dlt, "dlt_jacobi.cu",
        "mvgformer_tpu/geometry/triangulate.py:jacobi4_smallest (plain "
        "jnp that XLA fuses; with the affine, undistortion and softmax "
        "of mvgformer_tpu/models/decoder.py)",
        dlt_rows[0]["launches"], dlt_rows[0]["max_abs_err_mm"],
        dlt_rows[0]["ms"], dlt_rows[0]["plain_ms"], None,
        bounds.dlt_jacobi(1, DLT_POINTS, DLT_VIEWS), dlt_rows[0]["at"],
        by_shape=dlt_rows, device_ms=dlt_rows[0]["device_ms"],
        ptxas=reports["dlt_jacobi.cu"]))
    # its backward in a training step; `plain_ms` autograd's backward of
    # the plain chain
    kernels.append(kernel_row(
        dlt_jacobi.fused_dlt, "dlt_jacobi.cu",
        "jax.grad through the same chain (XLA's fused VJP of "
        "jacobi4_smallest's sweeps)", dlt_bwd["launches"], None,
        dlt_bwd["ms"], dlt_bwd["plain_ms"], None,
        bounds.dlt_jacobi_bwd(*DLT_BWD_SHAPE), dlt_bwd["at"],
        name="fused_dlt.backward", max_rel_err=dlt_bwd["max_rel_err"],
        errors=dlt_bwd["errors"], device_ms=dlt_bwd["device_ms"]))
    # a served frame: the dense layer 1, then the top-64 layers
    topm_rows = [{**sh, "launches": n} for sh, n in zip(
        topm_shapes, (1, topm_launches["serve_b1"] - 1))]
    kernels.append(kernel_row(
        point_topm.point_topm, "point_topm.cu",
        "none (mvgformer_tpu/ops/projattn.py: lax.top_k and the gathers, "
        "which XLA fuses)", topm_launches["serve_b1"],
        topm_rows[0]["max_rel_err"], topm_rows[0]["ms"],
        topm_rows[0]["plain_ms"], None,
        bounds.point_topm(*TOPM_SHAPES[0], TOPM_M), topm_rows[0]["at"],
        by_shape=topm_rows, device_ms=topm_rows[0]["device_ms"],
        ptxas=reports["point_topm.cu"]))
    for fn, source, replaces, also, library, probe_shape in PROBE_ROWS:
        kernels.append(probe_row(fn, source, replaces, also, library,
                                 probe_shape, probe_stats[fn],
                                 probe_launches[fn.__name__], turns))
    serving_training = {fn.__name__ for fn in ALL_KERNELS}
    for row in kernels:
        if row["name"] in serving_training:
            row["cli_launches"] = {run: counts[row["name"]]
                                   for run, counts in cli_runs.items()}
            # each path driven with the counts set to 0 just before it
            row["path_launches"] = {
                path: counts.get(row["name"], 0)
                for path, counts in path_launches.items()}
    # phase 24a: each kernel at the ablation config's shapes (D 16)
    for row in kernels:
        st = ablation_stats.get(row["name"])
        if row["name"] == "deform_sample":
            row["ablation_d16"] = [
                {"at": f"bfloat16 N=5 Lq={Lq} H=8 D=16 L=3 P={P} "
                       f"(levels {ABL_LEVELS})", **stats}
                for (Lq, P), stats in st.items()]
        elif st is not None:
            row["ablation_d16"] = {"at": ABLATION_AT[row["name"]], **st}
    # the launch floor beside every row and shape whose bound per launch
    # lies under it
    for row in kernels:
        for entry in (row, *row.get("by_shape", ())):
            if entry["bound_ms"] / entry.get("timed_launches", 1) < floor_ms:
                entry["floor_ms"] = floor_ms
    phase("ranking", order=ranking(kernels), card=card)
    print(json.dumps({"kernels": kernels, "floor_ms": floor_ms}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
