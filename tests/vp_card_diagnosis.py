"""Two diagnoses of chip_smoke.py's parallel phases on the card, kept out
of the smoke run. Run from the repository root on a machine with a card:

    python tests/vp_card_diagnosis.py [split_gaps] [bounds_flips]

split_gaps: where the bf16 gradient gap of phase 20a (2 data ranks x 1
frame against 1 process x 2 frames) and of phase 23c (5 view ranks x 1
view against 1 process x 5 views) comes from. The split step and the one
process run once through the training kernels (B2, B3 forward and
backward) and once through their plain versions, on the same inputs. One
JSON line per (phase, run): the largest leaf gaps of the bf16 split, its
sampling_offsets leaves, the one process's own bf16 rounding of the same
leaves (its bf16 gradient against its float32 one), and the leaves over
chip_smoke's `bf16_grad_bounds`.

bounds_flips: phase 23d's comparison (the MvP baseline, 'cat_proj',
float32, the 5 view ranks against one process) made twice, each time in
fresh processes, and the one process once more on the CPU. One JSON line
per comparison: the tokens `chip_smoke.bounds_flips` finds, with their
distance in pixels from the image edge in both runs and the last layer's
3D gap at the token.

The kernels are built from the checkout first, as chip_smoke.py builds
them. Nothing here imports JAX.
"""

import json
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from mvgformer_tpu_torch.ops import (_build, table_build,  # noqa: E402
                                     table_gather)

DEVICE = "cuda"


def plain_training_sampler():
    """Route the training sampler's kernels (B2, and B3 forward and
    backward) to their plain versions on the card's tensors, in this
    process; returns the undo."""
    saved = (table_build.build_corner_table,
             table_gather.gather_reduce_forward,
             table_gather.gather_reduce_backward)
    table_build.build_corner_table = table_build.build_corner_table_plain
    table_gather.gather_reduce_forward = \
        table_gather.deform_gather_reduce_plain
    table_gather.gather_reduce_backward = (
        lambda tables, idx, w4, ct, segments=None:
        table_gather.gather_reduce_backward_plain(tables, idx, w4, ct))

    def undo():
        (table_build.build_corner_table, table_gather.gather_reduce_forward,
         table_gather.gather_reduce_backward) = saved
    return undo


def train_grads(cfg, batch, dp=None):
    """One flagship training step of `cfg` on `batch` (this rank's shard
    under `dp`): the gradients, reduced over the grid, on the host."""
    from mvgformer_tpu_torch.core.train import (create_train_state,
                                                make_train_step)
    from mvgformer_tpu_torch.models.mvgformer import MVGFormer

    device = batch.views.device
    model = MVGFormer(cfg, generator=torch.Generator().manual_seed(cs.SEED),
                      device=device)
    state, tx = create_train_state(cfg, model)
    make_train_step(cfg, model, tx, dp=dp)(state, batch)
    grads = {k: p.grad.float().cpu() for k, p in model.named_parameters()
             if p.grad is not None}
    del model, state
    cs.bench.empty_cache(device)
    return grads


def split_worker(dp, cfg, batch_fn, plain, out_dir):
    """A split step on one rank; rank 0's gradients to <out_dir>."""
    from mvgformer_tpu_torch.device import strict_float32
    from mvgformer_tpu_torch.parallel import shard_batch

    strict_float32()
    undo = plain_training_sampler() if plain else None
    try:
        grads = train_grads(cfg, shard_batch(batch_fn(cfg, dp.device), dp),
                            dp)
    finally:
        if undo:
            undo()
    if dp.rank == 0:
        torch.save(grads, Path(out_dir) / "grads.pt")


def split_gaps(card, top=8):
    from mvgformer_tpu_torch.parallel import spawn

    for phase, batch_fn, world, views in (
            ("20a", cs.dp_global_batch, cs.DP_RANKS, 1),
            ("23c", cs.vp_frame, cs.VP_VIEWS, cs.VP_VIEWS)):
        for run in ("kernels", "plain"):
            undo = plain_training_sampler() if run == "plain" else None
            cfgs = {dtype: cs.dp_train_cfg(dtype)
                    for dtype in ("float32", "bfloat16")}
            try:
                single = {dtype: train_grads(cfg, batch_fn(cfg, DEVICE))
                          for dtype, cfg in cfgs.items()}
            finally:
                if undo:
                    undo()
            with tempfile.TemporaryDirectory(prefix="vp-diag-",
                                             dir=REPO / "build") as out:
                spawn(split_worker, world, DEVICE, cfgs["bfloat16"], batch_fn,
                      run == "plain", out, views=views)
                got = torch.load(Path(out) / "grads.pt")
            gaps = cs.leaf_gaps(got, single["bfloat16"])
            bound, rounding = cs.bf16_grad_bounds(single["bfloat16"],
                                                  single["float32"])
            largest = sorted(gaps, key=gaps.get, reverse=True)[:top]
            cs.phase("vp_diag_split_gaps", split=phase, run=run,
                     dtype="bfloat16", grid=f"{world // views}x{views}",
                     largest={k: gaps[k] for k in largest},
                     rounding_of_largest={k: rounding[k] for k in largest},
                     sampling_offsets={k: [gaps[k], rounding[k]]
                                       for k in gaps
                                       if "sampling_offsets" in k},
                     largest_rounding=max(rounding.values()),
                     median=sorted(gaps.values())[len(gaps) // 2],
                     leaves_over_bound={k: [g, bound[k]]
                                        for k, g in gaps.items()
                                        if g > bound[k]}, card=card)


def bounds_flips(card):
    from mvgformer_tpu_torch.models import build_model
    from mvgformer_tpu_torch.parallel import spawn

    cfg = cs.mvp_cfg("float32")
    served = {}
    for attempt in (1, 2):
        model = build_model(cfg, generator=torch.Generator().manual_seed(
            cs.SEED), device=DEVICE)
        frame = cs.vp_frame(cfg, DEVICE)
        single = cs.vp_serve_run(cfg, model, frame, None, None, DEVICE,
                                 timed=False)
        del model
        cs.bench.empty_cache(DEVICE)
        with tempfile.TemporaryDirectory(prefix="vp-diag-",
                                         dir=REPO / "build") as out:
            spawn(cs.vp_serve_worker, cs.VP_VIEWS, DEVICE, {"mvp": cfg}, out,
                  views=cs.VP_VIEWS)
            ranks = torch.load(Path(out) / "rank0.pt")["mvp"]
        served[attempt] = (single, ranks)
        report(card, f"ranks_vs_one_process_{attempt}", ranks, single,
               frame.view_data)
    t0 = time.perf_counter()
    model = build_model(cfg, generator=torch.Generator().manual_seed(
        cs.SEED), device="cpu")
    cpu = cs.vp_serve_run(cfg, model, cs.vp_frame(cfg, "cpu"), None, None,
                          "cpu", timed=False)
    single, ranks = served[1]
    report(card, "cpu_vs_one_process", cpu, single, frame.view_data,
           seconds=time.perf_counter() - t0)
    report(card, "cpu_vs_ranks", cpu, ranks, frame.view_data)
    report(card, "one_process_twice", served[2][0], single, frame.view_data)
    report(card, "ranks_twice", served[2][1], ranks, frame.view_data)


def report(card, name, got, want, view_data, **extra):
    _, where = cs.bounds_flips(got["layer_poses"], want["layer_poses"],
                               view_data)
    for f in where:
        g = got["poses"][f["batch"], f["token"]]
        w = want["poses"][f["batch"], f["token"]]
        f["last_layer_mm"] = (g - w).abs().max().item()
    gap = (got["poses"] - want["poses"]).abs()
    cs.phase("vp_diag_bounds_flips", compare=name, flips=where,
             last_layer_mm_max=gap.max().item(), card=card, **extra)


def main(argv):
    from mvgformer_tpu_torch.device import strict_float32

    parts = argv or ["split_gaps", "bounds_flips"]
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = cs.card_line()
    strict_float32()
    t0 = time.perf_counter()
    _build.build_all([_build.CSRC / s for s in cs.SOURCES])
    print(json.dumps({"built_s": time.perf_counter() - t0}), flush=True)
    for part in parts:
        {"split_gaps": split_gaps, "bounds_flips": bounds_flips}[part](card)
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
