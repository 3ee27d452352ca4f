"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA card and nvcc (CUDA_HOME or
/usr/local/cuda), and builds the port's kernels from the checkout's sources
into build/kernels/. Phases, each printed on its own line; any failure
exits non-zero:

  1. find the card and print its name and power limit;
  2. build the deformable-sampling kernel;
  3. hold the kernel against its plain PyTorch version on the card at the
     flagship shapes (float32 and bfloat16, edge and non-finite locations
     included) and time both with CUDA events;
  4. the flagship-width model (random weights from a fixed seed, float32,
     TF32 off): one frame through the kernel path on the card and through
     the plain path on the CPU, layer-1 logits and 3D compared at the
     golden tolerance classes;
  5. serve: bfloat16, batch 1, one camera rig, distinct synthetic frames
     through core.infer.make_eval_step; shape, NaN and kernel-launch checks,
     frames/s and peak device memory.

The last two lines are the kernel table and the device, as JSON.
"""

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mvgformer_tpu_torch.ops import deform_attn, sampling

REPO = Path(__file__).resolve().parent
SPATIAL_SHAPES = ((128, 240), (64, 120), (32, 60))  # flagship levels
N_VIEWS, HEADS, HEAD_DIM = 5, 8, 32
SEED = 0
THRESHOLD = 0.1
SERVE_FRAMES, SERVE_WARMUP = 10, 2


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


def sampling_inputs(Lq, P, dtype, gen):
    """Kernel inputs on the card with border, far-outside and non-finite
    locations mixed into the uniform ones."""
    L = len(SPATIAL_SHAPES)
    len_in = sum(h * w for h, w in SPATIAL_SHAPES)
    dev = "cuda"
    value = torch.randn(N_VIEWS, len_in, HEADS, HEAD_DIM, device=dev,
                        generator=gen).to(dtype)
    loc = torch.rand(N_VIEWS, Lq, HEADS, L, P, 2, device=dev,
                     generator=gen) * 1.2 - 0.1
    w = torch.tensor([s[1] for s in SPATIAL_SHAPES], device=dev)
    h = torch.tensor([s[0] for s in SPATIAL_SHAPES], device=dev)
    q = Lq // 8
    u = torch.rand(N_VIEWS, q, HEADS, L, P, device=dev, generator=gen)
    # x in (-1, 0) pixels, then y in [h-1, h) pixels
    loc[:, :q, ..., 0] = (-u + 0.5) / w[:, None]
    loc[:, q:2 * q, ..., 1] = (h[:, None] - 1 + u + 0.5) / h[:, None]
    loc[:, 2 * q:2 * q + 8] = 50.0
    loc[:, 2 * q + 8:2 * q + 16, ..., 0] = float("inf")
    loc[:, 2 * q + 16:2 * q + 24, ..., 1] = -float("inf")
    loc[:, 2 * q + 24:2 * q + 32, ..., 0] = float("nan")
    aw = torch.rand(N_VIEWS, Lq, HEADS, L, P, device=dev,
                    generator=gen).to(dtype)
    return value, loc, aw


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
    """Phase 3: kernel against the plain version on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst_f32, serving = 0.0, None
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
            ms = cuda_ms(lambda: deform_attn.deform_sample(
                value, SPATIAL_SHAPES, loc, aw))
            plain_ms = cuda_ms(lambda: sampling.deform_sample(
                value, SPATIAL_SHAPES, loc, aw))
            phase("kernel_vs_plain", N=N_VIEWS, Lq=Lq, H=HEADS, D=HEAD_DIM,
                  L=len(SPATIAL_SHAPES), P=P, dtype=str(dtype),
                  max_abs_err=err, ok=bool(ok), ms=ms, plain_ms=plain_ms,
                  card=card)
            if not ok:
                fail(f"kernel disagrees with the plain version: Lq={Lq} "
                     f"P={P} {dtype} max abs err {err}")
            if (Lq, P, dtype) == (15360, 4, torch.bfloat16):
                serving = (ms, plain_ms)
    return worst_f32, serving


def check_slice(card):
    """Phase 4: kernel path on the card against the plain path on the CPU,
    flagship width, float32 with TF32 off."""
    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.device import strict_float32
    from mvgformer_tpu_torch.models.mvgformer import MVGFormer

    strict_float32()
    cfg = flagship_cfg("float32")
    model_cpu = MVGFormer(cfg, generator=torch.Generator().manual_seed(SEED))
    model_gpu = copy.deepcopy(model_cpu).cuda().eval()
    model_cpu.eval()
    batch = make_batch(cfg, batch_size=1, seed=SEED, num_people=3)
    before = deform_attn.deform_sample.launches
    with torch.inference_mode():
        t0 = time.perf_counter()
        gpu = model_gpu(batch.to("cuda"), threshold=THRESHOLD)[0]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cpu = model_cpu(batch, threshold=THRESHOLD)[0]
        t2 = time.perf_counter()
    if deform_attn.deform_sample.launches == before:
        fail("the card's forward did not launch the kernel")
    logits_gpu = gpu["pred_logits"].cpu().numpy()
    logits_cpu = cpu["pred_logits"].numpy()
    logit_err = float(np.abs(logits_gpu - logits_cpu).max())
    logits_ok = bool(np.allclose(logits_gpu, logits_cpu, rtol=1e-3,
                                 atol=2e-3))
    err3d = np.abs(gpu["pred_poses"].cpu().numpy()
                   - cpu["pred_poses"].numpy())
    p99, mx = float(np.percentile(err3d, 99)), float(err3d.max())
    finite = bool(np.isfinite(logits_gpu).all()
                  and torch.isfinite(gpu["pred_poses"]).all())
    phase("slice_kernel_vs_plain", layer=1, logits_max_abs_err=logit_err,
          poses_mm_p99=p99, poses_mm_max=mx, finite=finite,
          gpu_s=t1 - t0, cpu_s=t2 - t1, card=card)
    if not (logits_ok and p99 < 2.0 and mx < 6.0 and finite):
        fail("kernel path and plain path disagree on layer 1")
    del model_gpu
    torch.cuda.empty_cache()


def serve(card):
    """Phase 5: the serving path at bfloat16. Returns the kernel launches
    counted during it."""
    from mvgformer_tpu_torch.core.infer import make_eval_step
    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.models.mvgformer import MVGFormer

    cfg = flagship_cfg("bfloat16")
    model = MVGFormer(cfg, generator=torch.Generator().manual_seed(SEED))
    model = model.cuda()
    step = make_eval_step(cfg, model, THRESHOLD)
    frames = [make_batch(cfg, batch_size=1, seed=SEED + 1 + i,
                         num_people=3, cam_seed=SEED)
              for i in range(SERVE_FRAMES)]
    Q, J = cfg.DECODER.num_instance, cfg.DECODER.num_keypoints
    layers = cfg.DECODER.num_decoder_layers

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    deform_attn.deform_sample.launches = 0
    times = []
    for i, frame in enumerate(frames):
        t0 = time.perf_counter()
        pred = step(frame.to("cuda"))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if tuple(pred.shape) != (1, Q, J, 5):
            fail(f"pred shape {tuple(pred.shape)}")
        if torch.isnan(pred).any():
            fail(f"NaN in the pred of frame {i}")
        if deform_attn.deform_sample.launches != layers * (i + 1):
            fail(f"{deform_attn.deform_sample.launches} kernel launches "
                 f"after {i + 1} frames, expected {layers * (i + 1)}")
    launches = deform_attn.deform_sample.launches
    steady = times[SERVE_WARMUP:]
    phase("serve", frames=SERVE_FRAMES, batch=1, dtype="bfloat16",
          frames_per_s=len(steady) / sum(steady),
          first_frame_s=times[0], peak_mem_gib=(
              torch.cuda.max_memory_allocated() / 2 ** 30),
          kernel_launches=launches, card=card)
    return launches


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one GPU")
    card = card_line()
    phase("card", nvidia_smi=card, torch=torch.__version__,
          cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    lib = deform_attn.build()
    phase("build", seconds=time.perf_counter() - t0, library=str(lib))

    worst_f32, (ms, plain_ms) = check_kernel(card)
    check_slice(card)
    launches = serve(card)
    if launches == 0:
        fail("the serving path never launched the kernel")

    print(json.dumps({"kernels": [{
        "name": "deform_sample",
        "route": "cuda",
        "source": "mvgformer_tpu_torch/csrc/deform_sample.cu",
        "replaces": "mvgformer_tpu/ops/pallas_deform.py:32",
        "launches": launches,
        "max_abs_err": worst_f32,
        "ms": ms,
        "plain_ms": plain_ms,
        "at": "bfloat16 N=5 Lq=15360 H=8 D=32 L=3 P=4 (dense layer 1)",
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
