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
from mvgformer_tpu_torch.models import is_dq, serves_poses
from mvgformer_tpu_torch.models.voxelpose import voxel_pred
from mvgformer_tpu_torch.ops.window_sampling import WindowPlan
from mvgformer_tpu_torch.parallel.mesh import (DataParallel, gather_objects,
                                               shard_views)
from mvgformer_tpu_torch.utils.profiling import span


def make_eval_step(cfg: Config, model: torch.nn.Module, threshold: float,
                   window_plan: Optional[WindowPlan] = None,
                   with_escape_telemetry: bool = False,
                   dp: Optional[DataParallel] = None) -> Callable:
    """An inference step returning the reference's pred array
    (B, Q, J, 5) = xyz | (score > threshold) - 1 | score, from the last
    decoder layer. The batch must be on the model's device.

    window_plan: the rig-static layer-1 plan (`build_layer1_window_plan`,
    moved to the model's device once with `.to(device)`).
    with_escape_telemetry: return (pred, escaped_mass) instead, the
    attention mass that escaped the windows of layer 1 as a float32 scalar
    tensor (0 without a plan). The MvP baseline takes no plan: passing
    one raises; neither do the volumetric models (`models/voxelpose.py`,
    `models/volumetric.py`; `models.serves_poses`), which give the pred's
    poses and scores directly.
    dp: the (data x view) grid under data or view parallelism; the batch
    is this rank's shard (`parallel.shard_batch`) and every rank calls the
    step in turn. Under a view split the pred is the frame's, the same
    bits on every rank of a data row, and a plan of the rig's views is cut
    to the rank's. The volumetric models take no view split."""
    model.eval()
    dq = is_dq(cfg)
    if window_plan is not None and not dq:
        raise ValueError("the window plan is for the DQ model's layer 1; "
                         "the MvP baseline takes none")
    volumetric = serves_poses(cfg)
    if volumetric and dp is not None and dp.views > 1:
        raise ValueError(f"{cfg.TRANSFORMER} takes no view split")

    @torch.inference_mode()
    def eval_step(batch: Batch):
        with span("mvg.step"):
            if volumetric:
                poses, scores = model(batch, threshold=threshold)
                with span("mvg.pred"):
                    pred = voxel_pred(poses, scores, threshold)
                if not with_escape_telemetry:
                    return pred
                return pred, torch.zeros((), dtype=torch.float32,
                                         device=pred.device)
            # the MvP baseline filters no queries: the threshold only sets
            # the flag channel
            outs = (model(batch, threshold=threshold,
                          window_plan=window_plan, grid=dp)
                    if dq else model(batch, grid=dp))
            with span("mvg.pred"):
                return _pred(outs, threshold, with_escape_telemetry)

    return eval_step


def _pred(outs, threshold: float, with_escape_telemetry: bool):
    """The eval step's pred from the model's per-layer outputs, and the
    escaped mass with `with_escape_telemetry`."""
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
                    loss_step: Optional[Callable] = None,
                    dp: Optional[DataParallel] = None,
                    on_batch: Optional[Callable] = None) -> Predictions:
    """Run `eval_step` over every frame of `dataset` in order: batches made
    on the host by `dataset.batches` (the last one padded by repeating its
    last frame), placed on `device` by a Prefetcher, and their preds stored
    by frame index, so that the padding drops out (a repeated frame keeps
    its first prediction). With `with_escape_telemetry` the step returns
    (pred, escaped_mass), as `make_eval_step(..., with_escape_telemetry=
    True)` makes it; `loss_step` (DEBUG.LOG_VAL_LOSS) is run on each batch
    too and its terms summed; `on_batch(idx, batch, pred)` is called after
    each batch's step (the debug dumps).

    Under data parallelism (`dp` of more than one rank) `batch_size` is
    the global batch: each rank loads and predicts its rows of every
    batch, and the preds (host numpy, by frame index, in rank order), the
    escaped mass and the loss sums are gathered to every rank. Under a
    view split each rank keeps its views of the rows it loads, the steps
    must take the same `dp`, and only view rank 0 of each data row
    contributes its preds and sums (the row's other ranks hold the same
    ones)."""
    rows = dp.rows(batch_size) if dp is not None and dp.distributed else None
    preds: Dict[int, np.ndarray] = {}
    escaped, loss_sums, loss_batches = 0.0, {}, 0
    t0 = time.perf_counter()
    loader = DevicePlacer(device).prefetch(
        dataset.batches(batch_size, shuffle=False, drop_last=False,
                        rows=rows))
    for idx, batch in loader:
        if dp is not None:
            batch = shard_views(batch, dp)
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
            preds.setdefault(frame_idx, pred[b])
        if on_batch is not None:
            on_batch(idx, batch, pred)
    if rows is not None:
        if dp.view_rank:
            preds, escaped, loss_sums, loss_batches = {}, 0.0, {}, 0
        parts = gather_objects((preds, escaped, loss_sums, loss_batches), dp)
        preds, escaped, loss_sums, loss_batches = {}, 0.0, {}, 0
        for part_preds, part_esc, part_sums, part_batches in parts:
            for frame_idx, p in part_preds.items():
                preds.setdefault(frame_idx, p)
            escaped += part_esc
            for k, v in part_sums.items():
                loss_sums[k] = loss_sums.get(k, 0.0) + v
            loss_batches += part_batches
    return Predictions(preds=[preds[i] for i in sorted(preds)],
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
                     dp: Optional[DataParallel] = None, **kwargs):
    """The eval loop of both CLIs: `predict_dataset`, then `nms_evaluate`
    at the eval operating point. Returns (metrics, Predictions); under
    data parallelism the metrics are computed on rank 0 only (None on the
    others)."""
    run = predict_dataset(dataset, eval_step, batch_size, device, dp=dp,
                          **kwargs)
    if dp is not None and not dp.is_main:
        return None, run
    return nms_evaluate(dataset, run.preds), run
