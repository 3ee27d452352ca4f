"""Serving and training throughput across configurations on one card, the
counterpart of the root bench_detail.py:

    python -m mvgformer_tpu_torch.bench_detail [name-substrings...]
        [--device cpu] [--toy]

ROWS holds the root script's 26 rows, the same names and arguments: 20
serving rows (frames/s) and 6 training rows (steps/s), each printed as one
JSON line with the root script's keys plus the median, min and max over
REPEATS timed loops, the synchronizing CUDA operations of one frame or
step, each model kernel's launches per frame or step, the peak device
memory and the card. Serving rows time ITERS chained frames per loop
(`bench.time_frames`, the protocol of `mvgformer_tpu_torch.bench`); a
windowed row builds its layer-1 plan once, outside the loop. Training rows
time TRAIN_ITERS steps per loop through `core.train.make_train_step`, the
steps chained through the state, the dropout generator seeded once, the
totals summed on the device and read once after the synchronize.

A row that raises prints {"config": name, "error": ...} (its traceback to
stderr) and the next row runs, as the root script fails soft; `main` then
exits 1. `--device cpu`
runs the rows with the kernels' plain versions and measures no card (the
time keys are null); `--toy` takes the dry run's tiny widths and short
loops.
"""

from __future__ import annotations

import gc
import json
import sys
import time
import traceback
from typing import Callable, Optional, Sequence

import torch

from mvgformer_tpu_torch import bench
from mvgformer_tpu_torch.config import Config
from mvgformer_tpu_torch.device import resolve_device
from mvgformer_tpu_torch.utils.profiling import count_syncs, synchronize

ITERS = bench.ITERS
TRAIN_ITERS = 5
REPEATS = 3
TRAIN_WARMUP = 2
# --toy's loops: a CPU run times nothing
TOY_TRAIN_LOOP = {"iters": 2, "repeats": 2, "warmup": 1}
SEED = bench.SEED
THRESHOLD = bench.THRESHOLD
SERVE, TRAIN = "serve", "train"


def _rows():
    """(name, kind, keyword arguments) in the root script's order."""
    rows = [
        ("topk128_jacobi_b1", SERVE, dict(topk=128, solver="jacobi")),
        ("topk256_jacobi_b1", SERVE, dict(topk=256, solver="jacobi")),
        ("topk256_svd_b1", SERVE, dict(topk=256, solver="linalg")),
        ("dense_jacobi_windowed_b1", SERVE,
         dict(topk=None, solver="jacobi", windowed=True)),
        ("dense_jacobi_b1", SERVE, dict(topk=None, solver="jacobi")),
        ("topk256_jacobi_b2", SERVE,
         dict(batch_size=2, topk=256, solver="jacobi")),
        ("train_gtmatch_linalg_b1", TRAIN, dict(solver="linalg")),
        ("train_gtmatch_jacobi_b1", TRAIN, dict(solver="jacobi")),
        ("train_gtmatch_eigh_b1", TRAIN, dict(solver="eigh")),
        ("train_gtmatch_jacobi_b1_chunk8", TRAIN,
         dict(solver="jacobi", sample_chunks=8)),
        ("train_gtmatch_jacobi_b2_chunk8", TRAIN,
         dict(batch_size=2, solver="jacobi", sample_chunks=8)),
        ("train_gtmatch_jacobi_b2", TRAIN,
         dict(batch_size=2, solver="jacobi")),
    ]
    for clamp, impl in ((4.0, "xla"), (2.0, "xla"), (4.0, "pallas"),
                        (2.0, "pallas"), (4.0, "pallas_dma"),
                        (2.0, "pallas_dma")):
        rows.append((f"topk128_jacobi_winclamp{int(clamp)}_{impl}_b1", SERVE,
                     dict(topk=128, solver="jacobi", windowed=True,
                          offset_clamp=clamp, window_impl=impl)))
    rows.append(("topk128_jacobi_clamp4_gather_b1", SERVE,
                 dict(topk=128, solver="jacobi", offset_clamp=4.0)))
    for m in (4, 2):
        for topk in (128, 64):
            rows.append((f"topk{topk}_jacobi_ptop{m}_b1", SERVE,
                         dict(topk=topk, solver="jacobi", point_topm=m)))
    rows.append(("topk64_jacobi_b1", SERVE, dict(topk=64, solver="jacobi")))
    rows.append(("topk64_jacobi_b2", SERVE,
                 dict(batch_size=2, topk=64, solver="jacobi")))
    rows.append(("topk64_jacobi_b4", SERVE,
                 dict(batch_size=4, topk=64, solver="jacobi")))
    return tuple(rows)


ROWS = _rows()


def serve_cfg(topk=None, solver="linalg", offset_clamp=None,
              window_impl="xla", point_topm=None,
              toy: bool = False) -> Config:
    """A serving row's config, as the root run_config sets it."""
    cfg = bench.flagship_cfg(toy)
    cfg.DECODER.inference_topk_queries = topk
    cfg.DECODER.triangulation_method = solver
    cfg.DECODER.layer1_offset_clamp = offset_clamp
    cfg.DECODER.layer1_window_impl = window_impl
    cfg.DECODER.inference_point_topm = point_topm
    return cfg


def train_cfg(solver="linalg", sample_chunks=None,
              toy: bool = False) -> Config:
    """A training row's config, as the root run_train_config sets it: the
    gt-match dense path, every decoder layer, the criterion, the backward
    and the clipped Adam step."""
    cfg = bench.flagship_cfg(toy)
    cfg.DECODER.gt_match = True
    cfg.DECODER.triangulation_method = solver
    cfg.TRAIN.SAMPLE_CHUNKS = sample_chunks
    return cfg


def _row_line(name: str, device: torch.device, card: str, rates, unit: str,
              batch_size: int, **fields) -> dict:
    """Print and return a row's line: the root script's keys (the median
    rate), then min, max, the repeats and `fields`."""
    spread = bench.spread(rates, device)
    if unit == "frames":
        head = {"fps_per_chip": spread["median"]}
    else:
        median = spread["median"]
        head = {"train_steps_per_sec_per_chip": median,
                "frames_per_sec_per_chip":
                    None if median is None else median * batch_size}
    line = {"config": name, **head, "min": spread["min"],
            "max": spread["max"], "repeats": len(rates), **fields,
            "device": card}
    print(json.dumps(line), flush=True)
    return line


def run_config(name, batch_size=1, topk=None, solver="linalg",
               windowed=False, offset_clamp=None, window_impl="xla",
               point_topm=None, *, device="cuda", toy=False,
               card: Optional[str] = None) -> dict:
    """One serving row: the chained protocol (`bench.time_frames`) over
    REPEATS loops of ITERS frames; B1 once per layer (layer 1 through B4
    or B5 on a windowed row, once per level)."""
    from mvgformer_tpu_torch.core.infer import make_eval_step
    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.models.mvgformer import (
        MVGFormer, build_layer1_window_plan, feature_spatial_shapes)

    device = resolve_device(device)
    card = card or bench.device_name(device)
    cfg = serve_cfg(topk, solver, offset_clamp, window_impl, point_topm, toy)
    model = MVGFormer(cfg, generator=torch.Generator().manual_seed(SEED),
                      device=device)
    batch = make_batch(cfg, batch_size=batch_size, seed=SEED, num_people=3,
                       device=device)
    plan = (build_layer1_window_plan(cfg, batch.view_data, device=device)
            if windowed else None)
    step = make_eval_step(cfg, model, THRESHOLD, window_plan=plan)
    loop = (bench.frame_loop(True) if toy
            else {"iters": ITERS, "repeats": REPEATS,
                  "warmup": bench.WARMUP_FRAMES})
    run = bench.time_frames(step, batch, device, **loop)
    layers = cfg.DECODER.num_decoder_layers
    want = {fn.__name__: 0 for fn in bench.MODEL_KERNELS}
    if device.type == "cuda":
        want["deform_sample"] = layers - windowed
        if windowed:
            window = ("window_block_dma" if window_impl == "pallas_dma"
                      else "window_block_matmul")
            want[window] = len(feature_spatial_shapes(cfg))
    Q, J = cfg.DECODER.num_instance, cfg.DECODER.num_keypoints
    bad = []
    if run["shape"] != (batch_size, Q, J, 5):
        bad.append(f"pred shape {run['shape']}")
    if not run["finite"]:
        bad.append("a non-finite pred or eps")
    if any(per != want for per in run["launches_per_frame"]):
        bad.append(f"launches per frame {run['launches_per_frame']}, "
                   f"expected {want}")
    if bad:
        raise RuntimeError(f"{name}: " + "; ".join(bad))
    return _row_line(name, device, card,
                     [loop["iters"] * batch_size / s for s in run["seconds"]],
                     "frames", batch_size, frames_per_repeat=loop["iters"],
                     batch=batch_size, syncs_per_frame=run["syncs"],
                     launches_per_frame=run["launches_per_frame"][-1],
                     peak_gib=run["peak_gib"])


def chained_steps(step: Callable, state, batch, generator, steps: int):
    """`steps` training steps back to back, chained through the state (the
    counterpart of the root script's lax.scan with the TrainState as its
    carry), dropout drawn from `generator`; nothing is read back. Returns
    the state and each step's total as a 1-d tensor on the device."""
    totals = []
    for _ in range(steps):
        state, metrics = step(state, batch, generator)
        totals.append(metrics["total"].float())
    return state, torch.stack(totals)


def run_train_config(name, batch_size=1, solver="linalg", iters=TRAIN_ITERS,
                     sample_chunks=None, *, device="cuda", toy=False,
                     card: Optional[str] = None) -> dict:
    """One training row: TRAIN_WARMUP steps, one step counted for its
    synchronizing operations (on the card), then REPEATS loops of `iters`
    steps chained through the state, each kernel's launches counted; the
    totals are summed on the device and read once per loop, after its
    synchronize."""
    from mvgformer_tpu_torch.core.train import (create_train_state,
                                                make_train_step)
    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.models.mvgformer import (MVGFormer,
                                                      feature_spatial_shapes)

    device = resolve_device(device)
    card = card or bench.device_name(device)
    cfg = train_cfg(solver, sample_chunks, toy)
    model = MVGFormer(cfg, generator=torch.Generator().manual_seed(SEED),
                      device=device)
    batch = make_batch(cfg, batch_size=batch_size, seed=SEED, num_people=3,
                       device=device)
    state, tx = create_train_state(cfg, model)
    step = make_train_step(cfg, model, tx)
    # a CPU generator: the step draws its dropout seeds from it on the host
    gen = torch.Generator().manual_seed(SEED + 1)
    loop = (TOY_TRAIN_LOOP if toy
            else {"iters": iters, "repeats": REPEATS,
                  "warmup": TRAIN_WARMUP})

    def chain(n):
        nonlocal state
        state, totals = chained_steps(step, state, batch, gen, n)
        return totals.sum()

    chain(loop["warmup"])
    synchronize(device)
    syncs = None
    if device.type == "cuda":
        syncs = count_syncs(chain, 1)[1]
    synchronize(device)
    bench.empty_cache(device)
    seconds, per_step, totals = [], [], []
    for _ in range(loop["repeats"]):
        before = bench.launches()
        t0 = time.perf_counter()
        total = chain(loop["iters"])
        synchronize(device)
        seconds.append(time.perf_counter() - t0)
        per_step.append(bench.launches_since(before, loop["iters"]))
        totals.append(float(total))
    if not all(torch.isfinite(torch.tensor(totals))):
        raise RuntimeError(f"{name}: non-finite totals {totals}")
    # per step on the card: the corner sampler once per layer and level,
    # its forward again under the decoder's remat
    want = {fn.__name__: 0 for fn in bench.MODEL_KERNELS}
    if device.type == "cuda":
        sampled = (cfg.DECODER.num_decoder_layers
                   * len(feature_spatial_shapes(cfg)))
        remat = 2 if cfg.PARALLEL.REMAT_DECODER else 1
        want.update(build_corner_table=remat * sampled,
                    gather_reduce_forward=remat * sampled,
                    gather_reduce_backward=sampled)
    if any(per != want for per in per_step):
        raise RuntimeError(f"{name}: launches per step {per_step}, "
                           f"expected {want}")
    return _row_line(name, device, card, [loop["iters"] / s for s in seconds],
                     "steps", batch_size, steps_per_repeat=loop["iters"],
                     batch=batch_size, syncs_per_step=syncs,
                     launches_per_step=per_step[-1],
                     total_per_repeat=totals, peak_gib=bench.peak_gib(device))


def main(argv: Optional[Sequence[str]] = None) -> list:
    args = bench.parse_args(argv, __doc__, rows=True)
    device = resolve_device(args.device)
    card = bench.device_name(device)
    t0 = time.perf_counter()
    bench.build_kernels(device)
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "device": card, "host": bench.host_info(device)}),
          flush=True)
    results, failed = [], []
    for name, kind, kwargs in ROWS:
        if args.only and not any(s in name for s in args.only):
            continue
        run = run_config if kind == SERVE else run_train_config
        try:
            results.append(run(name, **kwargs, device=device, toy=args.toy,
                               card=card))
        except Exception as e:  # noqa: BLE001 - report the row, run the rest
            traceback.print_exc()
            msg = f"{type(e).__name__}: {str(e).splitlines()[0][:300]}" \
                if str(e) else type(e).__name__
            print(json.dumps({"config": name, "error": msg}), flush=True)
            failed.append(name)
        finally:
            gc.collect()
            bench.empty_cache(device)
    if failed:
        print(json.dumps({"failed_rows": failed}), flush=True)
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
