"""The rank side of tests/test_torch_data_parallel.py: a function that
`mvgformer_tpu_torch.parallel.launch` runs on each of 2 gloo CPU ranks. It
imports only the port: the test process runs JAX and hands the ranks plain
data (the config as a dict, the port's state dict, port Batches).

For each case, every rank takes its rows of the global batch
(`shard_batch`), takes one `make_train_step(..., dp=dp)` from the same
weights and writes to <out>/<case>-rank<r>.npz its metrics (the mean over
the ranks), its gradients after the reduction and its parameters after
the Adam step."""

import os

import numpy as np
import torch


def port_config(sections: dict):
    """The port's Config with every field of `sections` (a config as
    nested dicts, e.g. dataclasses.asdict of the JAX package's)."""
    from mvgformer_tpu_torch.config import load_config

    cfg = load_config()
    for section, fields in sections.items():
        if isinstance(fields, dict):
            for key, val in fields.items():
                setattr(getattr(cfg, section), key, val)
        else:
            setattr(cfg, section, fields)
    return cfg


def train_one_step(dp, sections, state_dict, batches, out_dir):
    from mvgformer_tpu_torch.core.train import (create_train_state,
                                                make_train_step)
    from mvgformer_tpu_torch.models.mvgformer import MVGFormer
    from mvgformer_tpu_torch.parallel import replicated, shard_batch

    torch.set_num_threads(1)
    cfg = port_config(sections)
    model = MVGFormer(cfg, device=dp.device)
    for case, batch in batches.items():
        model.load_state_dict(state_dict)
        replicated(model, dp)
        state, tx = create_train_state(cfg, model)
        step = make_train_step(cfg, model, tx, dp=dp)
        _, metrics = step(state, shard_batch(batch, dp),
                          torch.Generator().manual_seed(
                              cfg.TRAIN.SEED + dp.rank))
        arrays = {f"metric/{k}": np.asarray(float(v))
                  for k, v in metrics.items()}
        for name, p in model.named_parameters():
            arrays[f"param/{name}"] = p.detach().numpy()
            if p.grad is not None:
                arrays[f"grad/{name}"] = p.grad.numpy()
        np.savez(os.path.join(out_dir, f"{case}-rank{dp.rank}.npz"),
                 **arrays)
    return {"world": dp.world, "backend": dp.backend}
