"""Entry points for a compile check and a dry run, the counterpart of the
root __graft_entry__.py: the flagship forward with its example arguments
(`entry`), and one training step and one eval step on a grid of ranks at
tiny widths (`dryrun_multichip`).

    python -m mvgformer_tpu_torch.graft_entry [N] [--device cpu]

runs the dry run on N ranks (default 8, as the root script's N_DEVICES),
on the card unless `--device cpu` asks for gloo ranks on the CPU. Ranks
that outnumber the visible cards share them, over gloo.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
from typing import Callable, Tuple

import numpy as np
import torch

from mvgformer_tpu_torch import bench
from mvgformer_tpu_torch.config import Config
from mvgformer_tpu_torch.device import resolve_device

THRESHOLD = bench.THRESHOLD


def entry(device=None) -> Tuple[Callable, tuple]:
    """(forward, (params, buffers, batch)) of the flagship config (1024
    queries x 15 joints, 5 views at 960x512, 4 decoder layers, d_model
    256; weights from seed 0, one synthetic frame), on the card unless
    `device` says otherwise. forward(params, buffers, batch) is a pure
    function of its arguments (`torch.func.functional_call` of the
    model) and returns the last layer's (pred_poses, pred_logits). It runs
    without autograd: the serving kernel has no backward."""
    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.models.mvgformer import MVGFormer

    device = resolve_device("cuda" if device is None else device)
    cfg = bench.flagship_cfg()
    model = MVGFormer(cfg, generator=torch.Generator().manual_seed(0),
                      device=device).eval()
    batch = make_batch(cfg, batch_size=1, seed=0, num_people=3,
                       device=device)
    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())

    def forward(params, buffers, batch):
        with torch.no_grad():
            outs = torch.func.functional_call(
                model, (params, buffers), (batch,),
                {"threshold": THRESHOLD})
        return outs[-1]["pred_poses"], outs[-1]["pred_logits"]

    return forward, (params, buffers, batch)


def dryrun_grid(n: int) -> Tuple[int, int]:
    """(data rows, views per row) of the dry run's grid: (n / 2) x 2 when n
    is even and at least 4, else n x 1."""
    if n % 2 == 0 and n >= 4:
        return n // 2, 2
    return n, 1


def dryrun_cfg(n: int) -> Config:
    """The dry run's config on `n` ranks: the tiny widths (bench.TOY) in
    float32, 4 cameras under a view split (2 per view rank), else 3.
    Dropout is off: each data row draws its own masks, so only without it
    is the grid's step the one process's step on the global batch, which
    is what the dry run can be held to."""
    cfg = bench.flagship_cfg(toy=True)
    cfg.DATASET.CAMERA_NUM = 4 if dryrun_grid(n)[1] == 2 else 3
    cfg.PARALLEL.COMPUTE_DTYPE = "float32"
    cfg.DECODER.dropout = 0.0
    return cfg


def dryrun_batch(cfg: Config, data_size: int):
    """The dry run's global batch: `data_size` frames of 2 people, on the
    CPU."""
    from mvgformer_tpu_torch.data.synthetic import make_batch

    return make_batch(cfg, batch_size=data_size, seed=0, num_people=2,
                      device="cpu")


def _dryrun_rank(dp, cfg: Config, n: int) -> dict:
    """One rank of the dry run: the model from seed 0, this rank's shard of
    the global batch, one training step and one eval step; rank 0 returns
    the step's total and the global pred (the data rows' preds in order)."""
    from mvgformer_tpu_torch.core.infer import make_eval_step
    from mvgformer_tpu_torch.core.train import (create_train_state,
                                                make_train_step)
    from mvgformer_tpu_torch.models.mvgformer import MVGFormer
    from mvgformer_tpu_torch.parallel import shard_batch
    from mvgformer_tpu_torch.parallel.mesh import gather_objects

    for fn in bench.MODEL_KERNELS:
        fn.launches = 0
    model = MVGFormer(cfg, generator=torch.Generator().manual_seed(0),
                      device=dp.device)
    local = shard_batch(dryrun_batch(cfg, dp.data_world), dp).to(dp.device)
    state, tx = create_train_state(cfg, model)
    step = make_train_step(cfg, model, tx, num_replicas=n, dp=dp)
    state, metrics = step(state, local, torch.Generator().manual_seed(
        cfg.TRAIN.SEED + dp.data_rank))
    total = float(metrics["total"])
    pred = make_eval_step(cfg, model, THRESHOLD, dp=dp)(local)
    parts = gather_objects((dp.view_rank, pred.cpu().numpy()), dp)
    rows = np.concatenate([p for view_rank, p in parts if view_rank == 0])
    return {"total": total, "pred": rows, "launches": bench.launches()}


def dryrun_multichip(n: int, device=None) -> dict:
    """One training step and one eval step on `n` ranks spawned by
    `parallel.spawn`, on the card unless `device` says otherwise: a (n/2 x
    2) data x view grid when n is even and at least 4, else n data ranks.
    On the card rank r takes cuda:(r % visible cards), and ranks sharing a
    card meet over gloo. Raises unless the step's total is finite and the
    eval pred holds a row per data rank; returns rank 0's total, the
    global pred and rank 0's kernel launches over the two steps."""
    from mvgformer_tpu_torch.parallel import spawn

    device = resolve_device("cuda" if device is None else device)
    data_size, views = dryrun_grid(n)
    out = spawn(_dryrun_rank, n, device, dryrun_cfg(n), n, views=views)
    if not math.isfinite(out["total"]):
        raise RuntimeError(f"dry run on {n} ranks: total {out['total']}")
    if out["pred"].shape[0] != data_size:
        raise RuntimeError(f"dry run on {n} ranks: pred rows "
                           f"{out['pred'].shape[0]}, expected {data_size}")
    print(f"DRYRUN-OK on {n} {device.type} ranks", flush=True)
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n", nargs="?", type=int,
                        default=int(os.environ.get("N_DEVICES", "8")),
                        help="ranks (default: N_DEVICES, else 8)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    out = dryrun_multichip(args.n, args.device)
    print("dryrun ok", flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
