"""The rank side of tests/test_torch_view_parallel.py, and the same cases in
one process: `run_case` runs one serving or training case of the port on
this rank's shard of a global batch (`dp` a rank of a (data x view) grid)
or on the whole batch (`dp` None); `run_cases` is what
`mvgformer_tpu_torch.parallel.launch` runs on each rank. It imports only
the port: the test process hands the ranks plain data (configs as dicts,
state dicts, port Batches).

A case is a dict: name, kind ('eval', 'train' or 'predict'), sections
(the config as nested dicts), state_dict, and for 'eval' optionally
window (build the layer-1 window plan of the rig). A result holds numpy
arrays: for 'eval' every layer's outputs, the pred and the top-K indices
each compaction selected; for 'train' the metrics, the reduced gradients
and the parameters after the Adam step; for 'predict' the preds of
`predict_dataset` over PREDICT_FRAMES synthetic frames at batches of 2
(the batch is not read); all the collective counts of the run."""

import os
import pickle

import numpy as np
import torch

from torch_dp_worker import port_config

PREDICT_FRAMES = 5


def _selections():
    """Record every `top_indices` the DQ decoder calls; returns (list,
    undo)."""
    from mvgformer_tpu_torch.models import decoder

    taken = []
    original = decoder.top_indices

    def recording(scores, k):
        sel = original(scores, k)
        taken.append(sel.numpy().copy())
        return sel

    decoder.top_indices = recording

    def undo():
        decoder.top_indices = original
    return taken, undo


def run_case(case, batch, dp=None):
    """One case on `batch` (the global batch; this rank's shard of it
    under `dp`)."""
    from mvgformer_tpu_torch.core.infer import (make_eval_step,
                                                predict_dataset)
    from mvgformer_tpu_torch.core.train import (create_train_state,
                                                make_train_step)
    from mvgformer_tpu_torch.models import build_model, is_dq
    from mvgformer_tpu_torch.models.mvgformer import build_layer1_window_plan
    from mvgformer_tpu_torch.parallel import collectives, shard_batch

    cfg = port_config(case["sections"])
    model = build_model(cfg, device="cpu")
    model.load_state_dict(case["state_dict"])
    plan = None
    if case.get("window"):
        # the plan of the rig's every view; the model cuts its own
        plan = build_layer1_window_plan(cfg, batch.view_data, device="cpu")
    local = batch if dp is None else shard_batch(batch, dp)
    collectives.reset_counts()
    out = {}
    if case["kind"] == "eval":
        taken, undo = _selections()
        try:
            with torch.no_grad():
                outs = (model(local, threshold=0.1, window_plan=plan,
                              grid=dp) if is_dq(cfg)
                        else model(local, grid=dp))
            collectives.reset_counts()
            pred = make_eval_step(cfg, model, 0.1, window_plan=plan,
                                  dp=dp)(local)
            counts = dict(collectives.COUNTS)
        finally:
            undo()
        for lid, o in enumerate(outs):
            for k, v in o.items():
                out[f"layer{lid}/{k}"] = v.float().numpy()
        out["pred"] = pred.numpy()
        out["topk"] = taken[:len(taken) // 2]
    elif case["kind"] == "predict":
        from mvgformer_tpu_torch.data.datasets import SyntheticDataset

        dataset = SyntheticDataset(cfg, "validation", False,
                                   num_frames=PREDICT_FRAMES)
        step = make_eval_step(cfg, model, 0.1, dp=dp)
        run = predict_dataset(dataset, step, 2, "cpu", dp=dp)
        counts = dict(collectives.COUNTS)
        out["preds"] = np.stack(run.preds)
    else:
        state, tx = create_train_state(cfg, model)
        rank = 0 if dp is None else dp.data_rank
        step = make_train_step(cfg, model, tx, dp=dp)
        _, metrics = step(state, local, torch.Generator().manual_seed(
            cfg.TRAIN.SEED + rank))
        counts = dict(collectives.COUNTS)
        for k, v in metrics.items():
            out[f"metric/{k}"] = np.asarray(float(v))
        for name, p in model.named_parameters():
            out[f"param/{name}"] = p.detach().numpy().copy()
            if p.grad is not None:
                out[f"grad/{name}"] = p.grad.numpy().copy()
    out["counts"] = counts
    return out


def run_cases(dp, cases, batch, out_dir, round_trip=False):
    """Every case on this rank, and with `round_trip` the collectives'
    autograd check (`collectives_round_trip`); the results go to
    <out_dir>/rank<r>.pkl."""
    torch.set_num_threads(1)
    results = {case["name"]: run_case(case, batch, dp) for case in cases}
    if round_trip:
        results["round_trip"] = collectives_round_trip(
            dp, *round_trip_inputs())
    with open(os.path.join(out_dir, f"rank{dp.rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    return {"world": dp.world, "views": dp.views, "backend": dp.backend}


def round_trip_inputs():
    """(x (4, 3), theta (3,), w (3,)) of the round trip, from a seed."""
    g = torch.Generator().manual_seed(5)
    return (torch.randn(4, 3, generator=g), torch.randn(3, generator=g),
            torch.randn(3, generator=g))


def collectives_round_trip(dp, x_global, theta, w):
    """Part of tests/test_torch_view_parallel.py's autograd check on the
    view group: L = sum(all_gather(y) @ w) + sum(all_reduce_sum(sum_rows
    y^2) * theta) + sum(all_reduce_max(max_rows y)), y = tanh(x_r * theta)
    on this rank's rows x_r of x_global. Returns (L, dL/dtheta, dL/dx_r)
    of this rank."""
    from mvgformer_tpu_torch.parallel import collectives

    torch.set_num_threads(1)
    theta = theta.clone().requires_grad_(True)
    x = x_global[dp.view_slice(x_global.shape[0])].clone()
    x.requires_grad_(True)
    y = torch.tanh(x * theta)
    gathered = collectives.all_gather(y, dp, dim=0)
    summed = collectives.all_reduce_sum((y * y).sum(dim=0), dp)
    peak = collectives.all_reduce_max(y.max(dim=0).values, dp)
    loss = (gathered @ w).sum() + (summed * theta).sum() + peak.sum()
    loss.backward()
    result = (float(loss), theta.grad.numpy(), x.grad.numpy())
    rows = [None] * dp.world
    torch.distributed.all_gather_object(rows, result)
    return rows
