"""Device-resident trainer for the synthetic AP-ablation proxy.

    python -m mvgformer_tpu_torch.tools.ap_train_fast [--out DIR] \
        [--cfg YAML] [--resume] [--init_seed N] [--device cuda] \
        [KEY.SUB=value ...]

The port of tools/ap_train_fast.py. The proxy's dataset is small (48
frames of configs/synthetic_ap_ablation.yaml), so every frame of
SyntheticDataset(cfg, "train", True) is staged on the device once, and
the steps of an epoch are dispatched back to back in the order of
np.random.RandomState(TRAIN.SEED + epoch).permutation: the training step
(core.train.make_train_step, the same step the train CLI takes) reads
nothing back to the host, so the steps queue on the device and the only
synchronization is one metric read per epoch, written as one JSON line to
<out>/fast_train_metrics.jsonl (epoch, wall_s, the loss terms and
notfinite_total, rounded to 4 places).

The weights come from --init_seed (the CPU generator that draws them);
TRAIN.SEED drives the shuffle and the step's dropout generator, a CPU
generator seeded from (TRAIN.SEED, start epoch). A checkpoint in the
port's format (utils/checkpoint.py, <out>/checkpoints) is written every 20
epochs and at the end, and --resume continues from the latest one; the
per-epoch shuffles are the same across a resume. Whatever ends the run (an
interrupt, a failure), the end of the last whole epoch is saved from a
snapshot taken on the device at that epoch's end, never the parameters of
a partly run epoch. `python -m mvgformer_tpu_torch.tools.ap_ablation eval`
evaluates the checkpoint through the port's validate CLI.

`--device` defaults to the card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
CFG = str(REPO / "configs" / "synthetic_ap_ablation.yaml")
OUT = str(REPO / "output" / "torch_ap_ablation")
METRICS_FILE = "fast_train_metrics.jsonl"
CHECKPOINT_EVERY = 20


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--cfg", default=CFG)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in "
                         "--out/checkpoints")
    ap.add_argument("--init_seed", type=int, default=0,
                    help="seed of the weights' generator (TRAIN.SEED "
                         "drives only the shuffle and the step's dropout)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("overrides", nargs="*")
    return ap.parse_intermixed_args(argv)


class _Weights:
    """A state_dict held apart from the model, where save_checkpoint reads
    a model's."""

    def __init__(self, state_dict):
        self._sd = state_dict

    def state_dict(self):
        return self._sd


def snapshot(state):
    """The TrainState as it is now, kept from the following steps: the
    weights, which a step updates in place, copied on their device; the
    optimizer state as it is, since a step makes a new one."""
    from mvgformer_tpu_torch.core.train import TrainState

    weights = {k: v.detach().clone()
               for k, v in state.model.state_dict().items()}
    return TrainState(step=state.step, model=_Weights(weights),
                      opt_state=state.opt_state)


def stage_frames(cfg, device):
    """Every frame of the synthetic train split, one Batch each, on
    `device`."""
    from mvgformer_tpu_torch.data.datasets import SyntheticDataset

    ds = SyntheticDataset(cfg, "train", True)
    return [ds.load_batch([i], load_images=True).to(device)
            for i in range(len(ds))]


def step_generator(cfg, start_epoch: int) -> torch.Generator:
    """The step's dropout generator: a CPU generator from (TRAIN.SEED,
    start epoch), so the seeds are drawn on the host."""
    seed = np.random.SeedSequence([cfg.TRAIN.SEED, start_epoch])
    return torch.Generator().manual_seed(int(seed.generate_state(1)[0]))


def train(cfg, out: str, device, init_seed: int = 0, resume: bool = False,
          initial_weights=None, log=print) -> dict:
    """The fast trainer's loop (see the module docstring). initial_weights,
    where given, is a state_dict loaded over the weights drawn from
    init_seed. Returns {"start_epoch", "last_epoch", "epochs": the metric
    lines, "steps", "seconds", "ckpt_dir"}."""
    from mvgformer_tpu_torch.core.train import (create_train_state,
                                                make_train_step)
    from mvgformer_tpu_torch.models import build_model
    from mvgformer_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                      save_checkpoint)

    t0 = time.time()
    frames = stage_frames(cfg, device)
    n = len(frames)
    log(f"staged {n} frames on {device} in {time.time() - t0:.1f}s")
    model = build_model(cfg, generator=torch.Generator().manual_seed(
        init_seed), device=device)
    if initial_weights is not None:
        model.load_state_dict(initial_weights)
    state, tx = create_train_state(cfg, model, steps_per_epoch=n)
    step_fn = make_train_step(cfg, model, tx)

    ckpt_dir = os.path.join(out, "checkpoints")
    os.makedirs(out, exist_ok=True)
    start_epoch = 0
    if resume:
        restored = load_checkpoint(ckpt_dir, state)
        if restored is None:
            log("--resume: no checkpoint found, training from scratch")
        else:
            state, start_epoch, _ = restored
            log(f"resumed at epoch {start_epoch}")
    generator = step_generator(cfg, start_epoch)
    log_path = os.path.join(out, METRICS_FILE)
    t_start = time.time()
    last_saved = last_done = start_epoch - 1
    done = None  # the end of the last whole epoch, while not yet saved
    lines = []
    try:
        for epoch in range(start_epoch, cfg.TRAIN.END_EPOCH):
            t0 = time.time()
            perm = np.random.RandomState(cfg.TRAIN.SEED + epoch).permutation(n)
            metrics = None
            for i in perm:
                state, metrics = step_fn(state, frames[int(i)], generator)
            # the epoch's one read of the device
            metrics = {k: float(v) for k, v in metrics.items()}
            line = {"epoch": epoch, "wall_s": round(time.time() - t0, 1),
                    **{k: round(v, 4) for k, v in metrics.items()}}
            log(json.dumps(line))
            with open(log_path, "a") as f:
                f.write(json.dumps(line) + "\n")
            lines.append(line)
            last_done = epoch
            if ((epoch + 1) % CHECKPOINT_EVERY == 0
                    or epoch + 1 == cfg.TRAIN.END_EPOCH):
                save_checkpoint(ckpt_dir, state, epoch, next_epoch=epoch + 1)
                last_saved, done = epoch, None
                log(f"checkpointed epoch {epoch}")
            else:
                done = snapshot(state)
    finally:
        # a run ended mid-epoch holds part of the next epoch's updates in
        # `state`; the snapshot is the end of the last whole one
        if last_done > last_saved:
            save_checkpoint(ckpt_dir, done, last_done,
                            next_epoch=last_done + 1)
            log(f"checkpointed epoch {last_done} (final reached)")
    seconds = time.time() - t_start
    log(f"trained {last_done + 1} epochs in {seconds / 60:.1f} min")
    return {"start_epoch": start_epoch, "last_epoch": last_done,
            "epochs": lines, "steps": n * len(lines), "seconds": seconds,
            "ckpt_dir": ckpt_dir}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from mvgformer_tpu_torch.config import load_config
    from mvgformer_tpu_torch.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.cfg, args.overrides)
    return train(cfg, args.out, device, init_seed=args.init_seed,
                 resume=args.resume,
                 log=lambda msg: print(msg, flush=True))


if __name__ == "__main__":
    main()
