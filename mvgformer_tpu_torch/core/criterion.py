"""Set criterion: matching-based losses in a dense, static-shape form.

Port of `mvgformer_tpu/core/criterion.py`. The matched pairs are a dense
MatchResult (B, M, K) gather plus validity masks; every loss is a masked
sum with the original repository's normalizations:

  loss_ce                    = sum(focal(logits, onehot)) / num_samples
  loss_pose_perjoint         = sum(|pred - gt| * vis) / (num_samples * J * 3)
  loss_pose_perprojection_2d = sum(|pred2d - proj(gt)| * vis2d)
                               / (num_samples * V * J * 2), 0 when > 1e5
  num_samples                = max(sum(num_person), num_replicas)

or, under data parallelism (`dp`), clamp(mean over ranks of sum(num_person),
1) on each rank, as the original repository's all-reduce computes it; with
the gradients averaged over the ranks that gives the global batch's sum over
max(total, ranks), JAX's form on its global batch.

and per decoder layer, decay-weighted sums of the losses and means of the
logged rates (LOG_KEYS).

Under view parallelism (`dp` with a view world above 1) the batch's
view_data and the outputs' pred_poses_2d hold this rank's views: the two
reprojection terms sum over them and one sum all-reduce over the view
group adds the other views' sums (through its backward, every rank's
views get their gradient); the normalizers keep the frame's view count.
Every other term reads the targets and the replicated outputs.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from mvgformer_tpu_torch.config import Config
from mvgformer_tpu_torch.data.meta import Batch
from mvgformer_tpu_torch.data.synthetic import LIMBS15
from mvgformer_tpu_torch.geometry.cameras import project_points
from mvgformer_tpu_torch.geometry.transforms import apply_affine
from mvgformer_tpu_torch.models.matcher import (MatchResult, hungarian_match,
                                                knn_match, pose_l1_cost,
                                                threshold_match)
from mvgformer_tpu_torch.parallel import collectives
from mvgformer_tpu_torch.parallel.mesh import reduce_count


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25, gamma: float = 2.0
                       ) -> torch.Tensor:
    """Element-wise focal binary cross-entropy (before normalization)."""
    prob = torch.sigmoid(logits)
    ce = (torch.clamp(logits, min=0) - logits * targets
          + torch.log1p(torch.exp(-logits.abs())))
    p_t = prob * targets + (1 - prob) * (1 - targets)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
        loss = alpha_t * loss
    return loss


def _gather_pairs(x: torch.Tensor, query_idx: torch.Tensor) -> torch.Tensor:
    """x (B, Q, ...) at the matched pairs query_idx (B, M, K) ->
    (B, M, K, ...)."""
    B, M, K = query_idx.shape
    rows = torch.arange(B, device=x.device)[:, None]
    out = x[rows, query_idx.reshape(B, M * K)]
    return out.reshape((B, M, K) + tuple(x.shape[2:]))


def compute_layer_losses(cfg: Config, out: Dict[str, torch.Tensor],
                         batch: Batch, match: MatchResult,
                         num_samples: torch.Tensor,
                         match_ce: Optional[MatchResult] = None,
                         dp=None) -> Dict[str, torch.Tensor]:
    """Losses of one decoder layer's outputs. match_ce, when given, replaces
    the assignment of the classification loss only (use_ce_match). Under a
    view split (`dp`) the reprojection terms' view sums are reduced over
    the view group."""
    dec = cfg.DECODER
    targets = batch.targets
    vd = batch.view_data

    logits = out["pred_logits"].float()  # (B, Q, 2)
    B, Q, _ = logits.shape
    gt = targets.joints_3d.float()  # (B, M, J, 3) absolute mm
    _, M, J, _ = gt.shape
    V = vd.num_views  # this rank's views
    V_all = V * collectives.axis_size(dp)  # the frame's

    # threshold matching fills a variable number of the K slots
    if match.pair_valid is not None:
        pair_valid = match.pair_valid
    else:
        pair_valid = match.gt_valid[:, :, None].expand(match.query_idx.shape)
    pair_w = pair_valid.float()

    losses: Dict[str, torch.Tensor] = {}

    # labels (focal)
    ce_match = match_ce if match_ce is not None else match
    target_pos = ce_match.query_mask.float()  # (B, Q)
    onehot = torch.stack([torch.zeros_like(target_pos), target_pos], dim=-1)
    losses["loss_ce"] = sigmoid_focal_loss(logits, onehot).sum() / num_samples

    # logs: error, recall, precision
    thr = dec.pred_conf_threshold
    prob1 = torch.sigmoid(logits[..., 1])
    pred_pos = prob1 > thr
    matched = ce_match.query_mask
    n_matched = torch.clamp(matched.sum(), min=1)
    argmax_ok = (logits[..., 1] > logits[..., 0]) & matched
    losses["class_error"] = 100.0 * (1.0 - argmax_ok.sum() / n_matched)
    losses["class_recall"] = 100.0 * (pred_pos & matched).sum() / n_matched
    losses["class_precision"] = 100.0 * (pred_pos & matched).sum() / (
        pred_pos.sum() + 1e-5)

    # cardinality (log)
    card_pred = pred_pos.sum(dim=1).float()
    losses["cardinality_error"] = (
        card_pred - targets.num_person.float()).abs().mean()

    # per-joint 3D loss
    pred = out["pred_poses"].float().reshape(B, Q, J, 3)
    src = _gather_pairs(pred, match.query_idx)  # (B, M, K, J, 3)
    vis3d = targets.joints_3d_vis.float()  # (B, M, J)
    w3 = vis3d[:, :, None, :, None] * pair_w[..., None, None]
    d = src - gt[:, :, None]
    joint_type = dec.loss_joint_type
    if joint_type == "l1":
        losses["loss_pose_perjoint"] = (d.abs() * w3).sum() / (
            num_samples * J * 3)
    elif joint_type == "l2":
        losses["loss_pose_perjoint"] = ((d * w3) ** 2).sum() / (
            num_samples * J * 3)
    elif joint_type == "mpjpe":
        dist = torch.sqrt((d ** 2).sum(dim=-1) + 1e-12)
        wj = vis3d[:, :, None, :] * pair_w[..., None]
        per_pair = (dist * wj).sum(dim=-1) / torch.clamp(wj.sum(dim=-1),
                                                         min=1e-5)
        losses["loss_pose_perjoint"] = (per_pair * pair_w).sum() / num_samples
    else:
        raise ValueError(joint_type)

    # per-bone L1 (optional)
    if dec.use_loss_pose_perbone and J == 15:
        la = [a for a, _ in LIMBS15]
        lb = [b for _, b in LIMBS15]
        bone_src = src[..., la, :] - src[..., lb, :]
        bone_gt = (gt[..., la, :] - gt[..., lb, :])[:, :, None]
        wb = ((vis3d[..., la] * vis3d[..., lb])[:, :, None, :, None]
              * pair_w[..., None, None])
        losses["loss_pose_perbone"] = ((bone_src - bone_gt).abs() * wb).sum(
        ) / (num_samples * len(LIMBS15) * 3)

    # 3D-projected reprojection L1 (optional): pred and gt projected into
    # every camera, original-image coordinates
    if dec.use_loss_pose_perprojection:
        K = match.query_idx.shape[-1]
        src_flat = src.reshape(B, 1, M * K * J, 3).expand(B, V, M * K * J, 3)
        gt_flat = gt.reshape(B, 1, M * J, 3).expand(B, V, M * J, 3)
        proj_src = project_points(src_flat, vd.cameras).reshape(
            B, V, M, K, J, 2)
        proj_gt3 = project_points(gt_flat, vd.cameras).reshape(
            B, V, M, 1, J, 2)
        wp = (vd.joints_vis_2d[:, :, :, None, :, None]
              * pair_w[:, None, :, :, None, None])
        loss_pp = collectives.all_reduce_sum(
            ((proj_src - proj_gt3).abs() * wp).sum(), dp) / (
            num_samples * V_all * J * 2)
        losses["loss_pose_perprojection"] = torch.where(
            loss_pp > 1e5, torch.zeros_like(loss_pp), loss_pp)

    # 2D reprojection L1: gt projected with distortion, then the net affine
    if dec.use_loss_pose_perprojection_2d and "pred_poses_2d" in out:
        pred2d = out["pred_poses_2d"].float().reshape(B, V, Q, J, 2)
        src2d = _gather_pairs(pred2d.permute(0, 2, 1, 3, 4),
                              match.query_idx)  # (B, M, K, V, J, 2)
        gt_views = gt.reshape(B, 1, M * J, 3).expand(B, V, M * J, 3)
        proj_gt = project_points(gt_views, vd.cameras)  # (B, V, M*J, 2)
        proj_gt = apply_affine(proj_gt, vd.affine).reshape(B, V, M, J, 2)
        proj_gt = proj_gt.permute(0, 2, 1, 3, 4)  # (B, M, V, J, 2)
        vis2d = vd.joints_vis_2d.permute(0, 2, 1, 3)  # (B, M, V, J)
        w2 = vis2d[:, :, None, :, :, None] * pair_w[..., None, None, None]
        loss2d = collectives.all_reduce_sum(
            ((src2d - proj_gt[:, :, None]).abs() * w2).sum(), dp) / (
            num_samples * V_all * J * 2)
        # the original repository's kill switch
        losses["loss_pose_perprojection_2d"] = torch.where(
            loss2d > 1e5, torch.zeros_like(loss2d), loss2d)

    return losses


LOG_KEYS = ("class_error", "class_recall", "class_precision",
            "cardinality_error")


def layer_decay_weights(method: str, num_layers: int,
                        device=None) -> torch.Tensor:
    """Per-layer loss weights of DECODER.decay_method."""
    if method == "none":
        return torch.ones(num_layers, device=device)
    if method == "linear":
        return torch.linspace(0.0, 1.0, num_layers + 1, device=device)[1:]
    if method == "exp":
        w = 2.0 ** torch.arange(1, num_layers + 1, device=device,
                                dtype=torch.float32)
        return w / w[-1]
    if method == "last":
        w = torch.zeros(num_layers, device=device)
        w[-1] = 1.0
        return w
    raise ValueError(method)


def match_outputs(cfg: Config, out: Dict[str, torch.Tensor],
                  batch: Batch) -> MatchResult:
    """Per-layer matching on the layer's own outputs (gt_match off): KNN or
    'multiple' on the pose cost."""
    dec = cfg.DECODER
    gt = batch.targets.joints_3d.float()
    B, M, J, _ = gt.shape
    pred = out["pred_poses"].float().reshape(B, -1, J, 3)
    cost_pose = pose_l1_cost(pred, gt)
    if dec.match_method == "KNN":
        return knn_match(cost_pose, batch.targets.num_person,
                         int(dec.match_method_value))
    if dec.match_method == "multiple":
        return threshold_match(cost_pose, batch.targets.num_person,
                               float(dec.match_method_value),
                               k_cap=max(int(dec.num_instance // 8), 8))
    raise NotImplementedError(
        f"match_method {dec.match_method} on outputs is host-side")


def compute_losses(cfg: Config, layer_outputs: List[Dict[str, torch.Tensor]],
                   batch: Batch, match: Optional[MatchResult],
                   init_reference: Optional[torch.Tensor] = None,
                   num_replicas: int = 1,
                   dp=None) -> Dict[str, torch.Tensor]:
    """Decay-weighted per-layer criterion plus 'total', the weighted sum the
    step differentiates. With `match` (gt_match) one fixed match from the
    initial queries serves every layer, else each layer matches its own
    outputs. num_samples = max(sum(num_person), num_replicas): the global
    batch's count, as the original repository's all-reduced count nets out
    under data parallelism. With `dp` (a `parallel.DataParallel` of more
    than one rank) the batch is this rank's rows, and every count that
    normalizes a loss is the mean over the ranks, clamped at 1; under a
    view split the batch holds this rank's views (the module docstring)."""
    dec = cfg.DECODER
    num = batch.targets.num_person.sum().float()
    if dp is not None and dp.distributed:
        num_samples = torch.clamp(reduce_count(num, dp), min=1.0)
    else:
        num_samples = torch.clamp(num, min=float(num_replicas))

    def layer_losses(out):
        m = match if match is not None else match_outputs(cfg, out, batch)
        if dec.use_ce_match and match is not None:
            # the CE loss matches each layer's own outputs (pose-only
            # Hungarian on the host), so classification supervises the
            # final assignments
            J = batch.targets.joints_3d.shape[2]
            pred = out["pred_poses"].float().reshape(
                out["pred_poses"].shape[0], -1, J, 3)
            cost = pose_l1_cost(pred, batch.targets.joints_3d.float())
            m_ce = hungarian_match(cost, batch.targets.num_person)
            return compute_layer_losses(cfg, out, batch, m, num_samples,
                                        match_ce=m_ce, dp=dp)
        return compute_layer_losses(cfg, out, batch, m, num_samples, dp=dp)

    per_layer = [layer_losses(out) for out in layer_outputs]
    weights = layer_decay_weights(dec.decay_method, len(per_layer),
                                  device=num.device)

    summed: Dict[str, torch.Tensor] = {}
    for key in per_layer[0]:
        vals = torch.stack([pl[key] for pl in per_layer])
        if key in LOG_KEYS:
            summed[key] = vals.mean()
        else:
            summed[key] = (weights * vals).sum()
    # the init loss: per-joint loss of the initial reference points with
    # their own output matching, when gt_match is off
    if (dec.loss_weight_init > 0 and match is None
            and init_reference is not None):
        init_pred = init_reference
        if dec.convert_joint_format_indices is not None:
            cji = list(dec.convert_joint_format_indices)
            B0 = init_pred.shape[0]
            init_pred = init_pred.reshape(
                B0, -1, dec.num_keypoints, 3)[:, :, cji].reshape(B0, -1, 3)
        init_out = {"pred_logits": layer_outputs[0]["pred_logits"],
                    "pred_poses": init_pred}
        init_match = match_outputs(cfg, init_out, batch)
        # normalized by the matched-pair count, not num_samples
        pv = (init_match.pair_valid if init_match.pair_valid is not None
              else init_match.gt_valid[:, :, None].expand(
                  init_match.query_idx.shape))
        n_pairs = torch.clamp(reduce_count(pv.float().sum(), dp), min=1.0)
        init_losses = compute_layer_losses(cfg, init_out, batch, init_match,
                                           n_pairs)
        summed["loss_init"] = init_losses["loss_pose_perjoint"]
    else:
        summed["loss_init"] = torch.zeros((), device=num.device)

    weight_dict = {
        "loss_ce": dec.loss_weight_loss_ce,
        "loss_pose_perjoint": dec.loss_pose_perjoint,
        "loss_pose_perprojection_2d": dec.loss_pose_perprojection_2d,
        "loss_init": dec.loss_weight_init,
    }
    summed["total"] = sum(summed[k] * w for k, w in weight_dict.items()
                          if k in summed)
    return summed


def match_queries(cfg: Config, init_reference: torch.Tensor,
                  batch: Batch) -> MatchResult:
    """gt-match on the initial query poses (B, Q*J, 3) absolute mm: the
    pose-only cost, KNN, 'multiple' or Hungarian."""
    dec = cfg.DECODER
    J = dec.num_keypoints
    B = init_reference.shape[0]
    pred = init_reference.reshape(B, -1, J, 3)
    if dec.convert_joint_format_indices is not None:
        pred = pred[:, :, list(dec.convert_joint_format_indices)]
    gt = batch.targets.joints_3d.float()
    cost = pose_l1_cost(pred.float(), gt)
    if dec.match_method == "KNN":
        return knn_match(cost, batch.targets.num_person,
                         int(dec.match_method_value))
    if dec.match_method == "multiple":
        return threshold_match(cost, batch.targets.num_person,
                               float(dec.match_method_value),
                               k_cap=max(int(dec.num_instance // 8), 8))
    if dec.match_method in ("hungarian", "hungarian-dis"):
        return hungarian_match(cost, batch.targets.num_person)
    raise ValueError(f"unknown match_method {dec.match_method}")
