"""What the benchmark takes from the measured program, the PyTorch port
`mvgformer_tpu_torch`: its configuration loader, its model builder, the
serving entry `core.infer.make_eval_step` and its batch types, and its
counters (`counters`). Nothing else of the benchmark imports the port.
"""

from __future__ import annotations

import json
import sys

import torch

BACKBONE_RANGE = "bench.backbone"
# the port's counter registry, where it has one: a mapping of counter names
# to counts in `utils/profiling.py`
REGISTRY = "COUNTERS"


def config(spec: dict):
    """The port's Config: the configuration file's yaml, then every one of
    its settings. A configuration that states `"tf32": false` runs the
    port's float32 matmuls and convolutions in full float32
    (`device.strict_float32`); any other keeps torch's defaults."""
    from mvgformer_tpu_torch.config import load_config
    from mvgformer_tpu_torch.device import strict_float32

    if spec.get("tf32") is False:
        strict_float32()

    cfg = load_config(spec["yaml"])
    for key, value in spec["settings"].items():
        section, name = key.split(".") if "." in key else (None, key)
        obj = cfg if section is None else getattr(cfg, section)
        if not hasattr(obj, name):
            raise KeyError(f"{key} is not a setting of the port")
        setattr(obj, name, json.loads(json.dumps(value)))
    return cfg


def model(cfg, device):
    """The model that cfg.TRANSFORMER selects, on `device`, in eval mode
    (its weights are replaced by the benchmark's)."""
    from mvgformer_tpu_torch.models import build_model

    return build_model(cfg, generator=torch.Generator().manual_seed(0),
                       device=device).eval()


def eval_step(cfg, net, threshold: float):
    from mvgformer_tpu_torch.core.infer import make_eval_step

    return make_eval_step(cfg, net, threshold)


def train_step(cfg, net):
    """The port's training step (`core.train.make_train_step`) and its
    state at step 0."""
    from mvgformer_tpu_torch.core.train import (create_train_state,
                                                make_train_step)

    state, tx = create_train_state(cfg, net)
    return state, make_train_step(cfg, net, tx)


def batch(views: torch.Tensor, rig: dict, max_people: int, joints: int,
          targets: dict = None):
    """The port's Batch of device views (B, V, H, W, 3) on a rig of
    (B, V, ...) tensors; serving takes no targets, training takes
    joints_3d, joints_3d_vis, num_person and joints_vis_2d."""
    from mvgformer_tpu_torch.data.meta import Batch, Targets, ViewData
    from mvgformer_tpu_torch.geometry.cameras import CameraParams

    B, V = views.shape[:2]
    cams = CameraParams(**{k: rig[k] for k in "RTfckp"})
    vis2d = (targets["joints_vis_2d"] if targets is not None else
             torch.ones((B, V, max_people, joints), device=views.device))
    vd = ViewData(cameras=cams, centers=rig["centers"], scales=rig["scales"],
                  affine=rig["affine"], inv_affine=rig["inv_affine"],
                  joints_vis_2d=vis2d)
    tg = None if targets is None else Targets(
        joints_3d=targets["joints_3d"],
        joints_3d_vis=targets["joints_3d_vis"],
        roots_3d=targets["joints_3d"][:, :, 2].contiguous(),
        num_person=targets["num_person"])
    return Batch(views=views, view_data=vd, targets=tg)


def mark_backbone(net) -> None:
    """Open a profiler range around every call of the model's backbone."""
    def enter(module, args):
        module._bench_range = torch.autograd.profiler.record_function(
            BACKBONE_RANGE)
        module._bench_range.__enter__()

    def leave(module, args, out):
        module._bench_range.__exit__(None, None, None)

    net.backbone.register_forward_pre_hook(enter)
    net.backbone.register_forward_hook(leave)


def counters() -> dict:
    """A snapshot of the port's counters, by name: the serving DLT kernel's
    `fused_dlt.launches` and `fused_dlt.plain_calls` (`ops/dlt_jacobi.py`),
    each collective's forward calls as `collectives.<axis>.<kind>`
    (`parallel/collectives.py::COUNTS`), and every count of the port's
    registry (`utils/profiling.py::COUNTERS`) where it has one, under its
    own name."""
    from mvgformer_tpu_torch.ops.dlt_jacobi import fused_dlt
    from mvgformer_tpu_torch.parallel import collectives
    from mvgformer_tpu_torch.utils import profiling

    out = {"fused_dlt.launches": fused_dlt.launches,
           "fused_dlt.plain_calls": fused_dlt.plain_calls}
    out.update((f"collectives.{k}", v) for k, v in collectives.COUNTS.items())
    registry = getattr(profiling, REGISTRY, None)
    if registry is None:
        print(f"counters: the port has no registry "
              f"utils/profiling.py::{REGISTRY}; the record holds only "
              f"{', '.join(sorted(out))}", file=sys.stderr)
    else:
        out.update(registry)
    return {k: int(v) for k, v in out.items()}
