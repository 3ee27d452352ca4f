"""The serving entry point: one inference step per batch.

Port of `mvgformer_tpu/core/train.py::make_eval_step`.
"""

from __future__ import annotations

from typing import Callable

import torch

from mvgformer_tpu_torch.config import Config
from mvgformer_tpu_torch.data.meta import Batch
from mvgformer_tpu_torch.models.mvgformer import MVGFormer


def make_eval_step(cfg: Config, model: MVGFormer,
                   threshold: float) -> Callable[[Batch], torch.Tensor]:
    """An inference step returning the reference's pred array
    (B, Q, J, 5) = xyz | (score > threshold) - 1 | score, from the last
    decoder layer. The batch must be on the model's device."""
    del cfg  # the model carries its config; kept for the JAX signature
    model.eval()

    @torch.inference_mode()
    def eval_step(batch: Batch) -> torch.Tensor:
        out = model(batch, threshold=threshold)[-1]
        B, Q = out["pred_logits"].shape[:2]
        poses = out["pred_poses"].reshape(B, Q, -1, 3)
        J = poses.shape[2]
        score = torch.sigmoid(out["pred_logits"][:, :, 1:2])
        score = score[:, :, None].expand(B, Q, J, 1)
        flag = (score > threshold).to(poses.dtype) - 1.0
        return torch.cat([poses, flag, score], dim=-1)

    return eval_step
