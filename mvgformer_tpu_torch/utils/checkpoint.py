"""Checkpoints through torch.save.

The port's counterpart of `mvgformer_tpu/utils/checkpoint.py` (orbax there),
with its layout and meta: one file per epoch step under the checkpoint
directory, the latest 3 kept, and a `best/` directory keeping 1; meta
{"epoch": the NEXT epoch to run, "precision": the best metric so far,
"is_best"}. Saving over an existing step replaces it.

A file holds plain tensors, ints, floats and dicts only, so
`torch.load(path, weights_only=True)` reads it:

    {"model": the model's state_dict (CPU tensors),
     "opt_state": {"count", "mu", "nu", "notfinite_count",
                   "total_notfinite"} of core.train.OptState,
     "step": TrainState.step,
     "meta": {"epoch", "precision", "is_best"}}

As in the JAX package, no random-number state is saved: a resumed run
draws its dropout from TRAIN.SEED again.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import torch

MAX_TO_KEEP = 3
_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in tensors.items()}


def all_steps(ckpt_dir: str) -> List[int]:
    """The steps saved under `ckpt_dir`, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                                os.listdir(ckpt_dir)) if m)


def step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"{step}.pt")


def _save(ckpt_dir: str, step: int, payload: dict, max_to_keep: int):
    os.makedirs(ckpt_dir, exist_ok=True)
    path = step_path(ckpt_dir, step)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    for old in all_steps(ckpt_dir)[:-max_to_keep]:
        os.remove(step_path(ckpt_dir, old))


def save_checkpoint(ckpt_dir: str, state, epoch: int,
                    precision: Optional[float] = None,
                    is_best: bool = False,
                    next_epoch: Optional[int] = None) -> None:
    """Save a core.train.TrainState as step `epoch`.

    meta["epoch"] is the epoch a resumed run starts at: next_epoch=epoch+1
    for end-of-epoch saves, next_epoch=epoch for a mid-epoch preemption
    save (the interrupted epoch runs again). precision should be the best
    metric so far. With is_best the same payload also goes to `best/`."""
    opt = state.opt_state
    payload = {
        "model": _cpu(state.model.state_dict()),
        "opt_state": {"count": int(opt.count), "mu": _cpu(opt.mu),
                      "nu": _cpu(opt.nu),
                      "notfinite_count": int(opt.notfinite_count),
                      "total_notfinite": int(opt.total_notfinite)},
        "step": int(state.step),
        "meta": {"epoch": int(next_epoch if next_epoch is not None
                              else epoch),
                 "precision": float(precision or 0.0),
                 "is_best": bool(is_best)},
    }
    _save(ckpt_dir, epoch, payload, MAX_TO_KEEP)
    if is_best:
        _save(os.path.join(ckpt_dir, "best"), epoch, payload, 1)


def _read(ckpt_dir: str, step: Optional[int]) -> Optional[dict]:
    steps = all_steps(ckpt_dir)
    if step is None:
        if not steps:
            return None
        step = steps[-1]
    elif step not in steps:
        return None
    return torch.load(step_path(ckpt_dir, step), map_location="cpu",
                      weights_only=True)


def load_checkpoint(ckpt_dir: str, state, step: Optional[int] = None
                    ) -> Optional[Tuple[object, int, float]]:
    """Restore the latest (or the given) step into `state` (a
    core.train.TrainState: its model's weights in place, its optimizer
    moments on the model's device). Returns (state, next_epoch,
    best_precision), or None when there is no such step."""
    from mvgformer_tpu_torch.core.train import OptState, TrainState

    payload = _read(ckpt_dir, step)
    if payload is None:
        return None
    model = state.model
    model.load_state_dict(payload["model"])
    device = next(model.parameters()).device
    opt = payload["opt_state"]
    opt_state = OptState(
        count=opt["count"],
        mu={k: v.to(device) for k, v in opt["mu"].items()},
        nu={k: v.to(device) for k, v in opt["nu"].items()},
        notfinite_count=opt["notfinite_count"],
        total_notfinite=opt["total_notfinite"])
    meta = payload["meta"]
    return (TrainState(step=payload["step"], model=model,
                       opt_state=opt_state),
            meta["epoch"], meta["precision"])


def load_params_checkpoint(ckpt_dir: str, step: Optional[int] = None
                           ) -> Optional[Tuple[Dict[str, torch.Tensor], int]]:
    """The model's state_dict of a training checkpoint, and its next
    epoch: (state_dict, next_epoch), or None when there is no such step.
    The validate CLI's path."""
    payload = _read(ckpt_dir, step)
    if payload is None:
        return None
    return payload["model"], payload["meta"]["epoch"]


class PreemptionGuard:
    """Cooperative preemption: SIGTERM and SIGINT set a flag; the train
    loop checks `should_stop` at step boundaries and checkpoints before it
    exits, so a preempted job resumes where it stopped."""

    def __init__(self):
        import signal

        self._stop = False
        self._installed = False
        try:
            signal.signal(signal.SIGTERM, self._handler)
            signal.signal(signal.SIGINT, self._handler)
            self._installed = True
        except ValueError:
            pass  # not the main thread; polling still works via request()

    def _handler(self, signum, frame):
        self._stop = True

    def request(self):
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop


def load_backbone_pretrained(path: str, state_dict: Dict[str, torch.Tensor]
                             ) -> Dict[str, torch.Tensor]:
    """A PoseResNet `.pth.tar` pretrain (the original repo's
    lib/utils/utils.py:152-188) into a full model's state_dict: every
    `backbone.*` entry is replaced by the file's tensor of the same name
    (keys with or without 'module.' / 'backbone.'; its final_layer is not
    part of this model). BatchNorm's num_batches_tracked stays the
    model's, as in the JAX package, which keeps no such counter. Returns a
    new state_dict."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    src = {}
    for k, v in sd.items():
        for prefix in ("module.", "backbone."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        src[k] = v
    out = dict(state_dict)
    for key in state_dict:
        if not key.startswith("backbone."):
            continue
        name = key[len("backbone."):]
        if name.endswith("num_batches_tracked"):
            continue
        if name not in src:
            raise KeyError(f"{name} missing from the backbone checkpoint "
                           f"{path}")
        out[key] = torch.as_tensor(src[name]).to(state_dict[key].dtype)
    return out
