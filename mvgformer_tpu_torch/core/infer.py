"""The serving entry point: one inference step per batch.

Port of `mvgformer_tpu/core/train.py::make_eval_step`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from mvgformer_tpu_torch.config import Config
from mvgformer_tpu_torch.data.meta import Batch
from mvgformer_tpu_torch.models.mvgformer import MVGFormer
from mvgformer_tpu_torch.ops.window_sampling import WindowPlan


def make_eval_step(cfg: Config, model: MVGFormer, threshold: float,
                   window_plan: Optional[WindowPlan] = None,
                   with_escape_telemetry: bool = False) -> Callable:
    """An inference step returning the reference's pred array
    (B, Q, J, 5) = xyz | (score > threshold) - 1 | score, from the last
    decoder layer. The batch must be on the model's device.

    window_plan: the rig-static layer-1 plan (`build_layer1_window_plan`,
    moved to the model's device once with `.to(device)`).
    with_escape_telemetry: return (pred, escaped_mass) instead, the
    attention mass that escaped the windows of layer 1 as a float32 scalar
    tensor (0 without a plan)."""
    del cfg  # the model carries its config; kept for the JAX signature
    model.eval()

    @torch.inference_mode()
    def eval_step(batch: Batch):
        outs = model(batch, threshold=threshold, window_plan=window_plan)
        out = outs[-1]
        B, Q = out["pred_logits"].shape[:2]
        poses = out["pred_poses"].reshape(B, Q, -1, 3)
        J = poses.shape[2]
        score = torch.sigmoid(out["pred_logits"][:, :, 1:2])
        score = score[:, :, None].expand(B, Q, J, 1)
        flag = (score > threshold).to(poses.dtype) - 1.0
        pred = torch.cat([poses, flag, score], dim=-1)
        if not with_escape_telemetry:
            return pred
        escaped = torch.zeros((), dtype=torch.float32, device=poses.device)
        for o in outs:
            if "escaped_mass" in o:
                escaped = escaped + o["escaped_mass"]
        return pred, escaped

    return eval_step
