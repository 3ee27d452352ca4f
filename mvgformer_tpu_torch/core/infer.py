"""The serving entry point and the eval loop over a dataset.

`make_eval_step` is the port of `mvgformer_tpu/core/train.py::
make_eval_step`; `predict_dataset`, `nms_evaluate` and `evaluate_dataset`
are the eval loop that the JAX package's run/train.py and run/validate.py
each write out (batches -> eval step -> preds by frame index -> pose NMS ->
the dataset's metrics), shared here by the port's two CLIs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from mvgformer_tpu_torch.config import Config
from mvgformer_tpu_torch.core.nms import apply_pose_nms
from mvgformer_tpu_torch.data.meta import Batch
from mvgformer_tpu_torch.data.prefetch import DevicePlacer
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


@dataclasses.dataclass
class Predictions:
    """What `predict_dataset` returns."""

    preds: List[np.ndarray]        # per frame, (Q, J, 5), in frame order
    escaped_mass: float            # summed over batches (telemetry steps)
    loss_sums: Dict[str, float]    # per loss term, summed over batches
    loss_batches: int
    loop_s: float                  # host clock of the whole loop
    wait_s: float                  # of which the Prefetcher's wait


def predict_dataset(dataset, eval_step: Callable, batch_size: int, device,
                    with_escape_telemetry: bool = False,
                    loss_step: Optional[Callable] = None) -> Predictions:
    """Run `eval_step` over every frame of `dataset` in order: batches made
    on the host by `dataset.batches` (the last one padded by repeating its
    last frame), placed on `device` by a Prefetcher, and their preds stored
    by frame index, so that the padding drops out. With
    `with_escape_telemetry` the step returns (pred, escaped_mass), as
    `make_eval_step(..., with_escape_telemetry=True)` makes it; `loss_step`
    (DEBUG.LOG_VAL_LOSS) is run on each batch too and its terms summed."""
    preds: List[Optional[np.ndarray]] = [None] * len(dataset)
    escaped, loss_sums, loss_batches = 0.0, {}, 0
    t0 = time.perf_counter()
    loader = DevicePlacer(device).prefetch(
        dataset.batches(batch_size, shuffle=False, drop_last=False))
    for idx, batch in loader:
        out = eval_step(batch)
        if with_escape_telemetry:
            out, esc = out
            escaped += float(esc)
        pred = out.float().cpu().numpy()
        if loss_step is not None:
            for k, v in loss_step(batch).items():
                loss_sums[k] = loss_sums.get(k, 0.0) + float(v)
            loss_batches += 1
        for b, frame_idx in enumerate(idx):
            preds[frame_idx] = pred[b]
    return Predictions(preds=[p for p in preds if p is not None],
                       escaped_mass=escaped, loss_sums=loss_sums,
                       loss_batches=loss_batches,
                       loop_s=time.perf_counter() - t0,
                       wait_s=loader.total_wait_s)


def nms_evaluate(dataset, preds: List[np.ndarray], dist_thr: float = 0.3,
                 num_nearby_joints_thr: int = 7):
    """Pose NMS on each frame's preds, then the dataset's own metrics
    (a dict for the AP protocol, a PCP tuple for Shelf / Campus)."""
    return dataset.evaluate([apply_pose_nms(p, dist_thr,
                                            num_nearby_joints_thr)
                             for p in preds])


def evaluate_dataset(dataset, eval_step: Callable, batch_size: int, device,
                     **kwargs):
    """The eval loop of both CLIs: `predict_dataset`, then `nms_evaluate`
    at the eval operating point. Returns (metrics, Predictions)."""
    run = predict_dataset(dataset, eval_step, batch_size, device, **kwargs)
    return nms_evaluate(dataset, run.preds), run
