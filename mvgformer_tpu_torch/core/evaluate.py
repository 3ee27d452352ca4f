"""Evaluation metrics on the host, in numpy: AP / recall / MPJPE (the
Panoptic protocol) and PCP (Shelf / Campus). The port's own copy of
`mvgformer_tpu/core/evaluate.py`.

The inputs are per-frame (Q, J, 5) prediction arrays ([x, y, z, flag,
score]) from `core.infer.make_eval_step`, after pose NMS where wanted. The
order-sensitive greedy matching and the PCP evaluator follow the original
repo's lib/dataset/panoptic.py:493-764 and lib/dataset/shelf.py:255-332
line for line.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np


def build_eval_list(preds: Sequence[np.ndarray],
                    gt_joints: Sequence[np.ndarray],
                    gt_vis: Sequence[np.ndarray] | None = None,
                    method: str = "score_sort") -> Tuple[List[dict], int]:
    """Match each flagged prediction to its nearest gt person.

    preds:     per-frame (N_i, J, 5) arrays (already NMS'd if desired).
    gt_joints: per-frame (G_i, J, 3) arrays.
    gt_vis:    per-frame (G_i, J) visibility (default all-visible).
    Mirrors panoptic.py:499-569.
    """
    eval_list: List[dict] = []
    total_gt = 0
    for i, (pred, joints_3d) in enumerate(zip(preds, gt_joints)):
        if len(joints_3d) == 0:
            continue
        vis_i = (gt_vis[i] if gt_vis is not None
                 else np.ones(joints_3d.shape[:2]))
        pred = pred.copy()
        if method == "mpjpe_sort":
            gt_seen: List[int] = []
            for pose in pred:
                mpjpes = [
                    np.mean(np.sqrt(np.sum(
                        (pose[v > 0, 0:3] - gt[v > 0]) ** 2, axis=-1)))
                    for gt, v in zip(joints_3d, vis_i)]
                gt_id = int(total_gt + np.argmin(mpjpes))
                if gt_id not in gt_seen:
                    eval_list.append({"mpjpe": float(np.min(mpjpes)),
                                      "score": float(pose[0, 4]),
                                      "gt_id": gt_id})
                    gt_seen.append(gt_id)
        else:
            pred = pred[pred[:, 0, 3] >= 0]
            for pose in pred:
                mpjpes = [
                    np.mean(np.sqrt(np.sum(
                        (pose[v > 0, 0:3] - gt[v > 0]) ** 2, axis=-1)))
                    for gt, v in zip(joints_3d, vis_i)]
                eval_list.append({"mpjpe": float(np.min(mpjpes)),
                                  "score": float(pose[0, 4]),
                                  "gt_id": int(total_gt + np.argmin(mpjpes))})
        total_gt += len(joints_3d)
    return eval_list, total_gt


def eval_list_to_ap(eval_list, total_gt, threshold,
                    method="score_sort") -> Tuple[float, float]:
    """panoptic.py:711-740."""
    if method == "score_sort":
        eval_list.sort(key=lambda k: k["score"], reverse=True)
    elif method == "mpjpe_sort":
        eval_list.sort(key=lambda k: k["mpjpe"])
    total_num = len(eval_list)

    tp = np.zeros(total_num)
    fp = np.zeros(total_num)
    gt_det: List[int] = []
    for i, item in enumerate(eval_list):
        if item["mpjpe"] < threshold and item["gt_id"] not in gt_det:
            tp[i] = 1
            gt_det.append(item["gt_id"])
        else:
            fp[i] = 1
    tp = np.cumsum(tp)
    fp = np.cumsum(fp)
    recall = tp / (total_gt + 1e-5)
    precise = tp / (tp + fp + 1e-5)
    for n in range(total_num - 2, -1, -1):
        precise[n] = max(precise[n], precise[n + 1])

    precise = np.concatenate(([0], precise, [0]))
    recall = np.concatenate(([0], recall, [1]))
    index = np.where(recall[1:] != recall[:-1])[0]
    ap = np.sum((recall[index + 1] - recall[index]) * precise[index + 1])
    return float(ap), float(recall[-2])


def eval_list_to_mpjpe(eval_list, threshold=500,
                       method="score_sort") -> float:
    """panoptic.py:742-759."""
    if method == "score_sort":
        eval_list.sort(key=lambda k: k["score"], reverse=True)
    elif method == "mpjpe_sort":
        eval_list.sort(key=lambda k: k["mpjpe"])
    gt_det: List[int] = []
    mpjpes = []
    for item in eval_list:
        if item["mpjpe"] < threshold and item["gt_id"] not in gt_det:
            mpjpes.append(item["mpjpe"])
            gt_det.append(item["gt_id"])
    return float(np.mean(mpjpes)) if mpjpes else float("inf")


def eval_list_to_recall(eval_list, total_gt, threshold=500) -> float:
    """panoptic.py:761-764."""
    gt_ids = [e["gt_id"] for e in eval_list if e["mpjpe"] < threshold]
    return len(np.unique(gt_ids)) / (total_gt + 1e-8)


def evaluate_ap_mpjpe(preds, gt_joints, gt_vis=None,
                      method: str = "score_sort") -> Dict[str, float]:
    """Full Panoptic-protocol metrics: AP/Recall @ 25..150mm, MPJPE@500,
    Recall@500 (panoptic.py:564-574)."""
    eval_list, total_gt = build_eval_list(preds, gt_joints, gt_vis, method)
    out: Dict[str, float] = {}
    for t in np.arange(25, 155, 25):
        ap, rec = eval_list_to_ap(eval_list, total_gt, t, method)
        out[f"ap@{int(t)}"] = ap
        out[f"recall@{int(t)}"] = rec
    out["mpjpe"] = eval_list_to_mpjpe(eval_list, method=method)
    out["recall@500"] = eval_list_to_recall(eval_list, total_gt)
    return out


def evaluate_by_observability(preds, gt_joints, gt_vis2d_per_view,
                              num_views: int,
                              ob_percentiles=range(0, 100, 10),
                              method: str = "score_sort",
                              gt_vis3d=None):
    """Per-camera-observability AP breakdown (panoptic.py:577-703).

    For each gt person, the observation count at percentile `th` is the
    ceil(J*th/100)-th smallest per-joint view-visibility sum; gts (and
    their matched predictions) are bucketed by that count and scored with
    the full AP protocol per bucket.

    gt_vis2d_per_view: per frame (V, G, J) arrays of 2D visibility.
    gt_vis3d: optional per-frame (G, J) 3D visibility — the reference's
    breakdown reuses the main eval list built WITH joints_3d_vis
    (panoptic.py:505-569), so per-pair MPJPE skips invisible joints.
    Returns {(percentile, n_cameras): metrics-dict}.
    """
    eval_list, total_gt = build_eval_list(preds, gt_joints,
                                          gt_vis=gt_vis3d, method=method)

    # per global gt id: sorted per-joint view-visibility counts
    gt_obs_sorted: List[np.ndarray] = []
    for vis_v in gt_vis2d_per_view:
        vis_v = np.asarray(vis_v)  # (V, G, J)
        if vis_v.size == 0:
            continue
        counts = np.sort(vis_v.sum(axis=0), axis=-1)  # (G, J) ascending
        for g in range(counts.shape[0]):
            gt_obs_sorted.append(counts[g])

    num_joints = gt_obs_sorted[0].shape[0] if gt_obs_sorted else 15

    def obs_num(gt_id: int, ob_th: int) -> int:
        idx = int(np.ceil(num_joints * ob_th / 100))
        idx = min(idx, num_joints - 1)
        return int(gt_obs_sorted[gt_id][idx])

    out = {}
    for ob_th in ob_percentiles:
        gt_buckets = [[] for _ in range(num_views + 1)]
        pd_buckets = [[] for _ in range(num_views + 1)]
        for gt_id in range(total_gt):
            n = min(max(obs_num(gt_id, ob_th), 0), num_views)
            gt_buckets[n].append(gt_id)
        for item in eval_list:
            n = min(max(obs_num(item["gt_id"], ob_th), 0), num_views)
            pd_buckets[n].append(dict(item))
        for n in range(1, num_views + 1):
            if not gt_buckets[n]:
                continue
            metrics = {}
            for t in np.arange(25, 155, 25):
                ap, rec = eval_list_to_ap(pd_buckets[n],
                                          len(gt_buckets[n]), t, method)
                metrics[f"ap@{int(t)}"] = ap
                metrics[f"recall@{int(t)}"] = rec
            metrics["mpjpe"] = eval_list_to_mpjpe(pd_buckets[n],
                                                  method=method)
            metrics["num_gt"] = len(gt_buckets[n])
            metrics["num_pred"] = len(pd_buckets[n])
            out[(100 - ob_th, n)] = metrics
    return out


# Shelf/Campus PCP limbs over the 14-joint converted format
# (shelf.py:272-273)
PCP_LIMBS = [[0, 1], [1, 2], [3, 4], [4, 5], [6, 7],
             [7, 8], [9, 10], [10, 11], [12, 13]]
PCP_BONE_GROUPS = OrderedDict(
    [("Head", [8]), ("Torso", [9]), ("Upper arms", [5, 6]),
     ("Lower arms", [4, 7]), ("Upper legs", [1, 2]),
     ("Lower legs", [0, 3])])


def evaluate_pcp(preds: Sequence[np.ndarray],
                 gt_per_frame: Sequence[Sequence[np.ndarray]],
                 num_actors: int,
                 recall_threshold: float = 500.0,
                 alpha: float = 0.5):
    """Per-actor PCP (shelf.py:255-332).

    preds:        per-frame (N_i, J, 5); only flagged poses count.
    gt_per_frame: per-frame list of per-actor (14, 3) arrays in mm, or an
                  empty array when the actor is absent.
    Returns (actor_pcp, avg_pcp (actors 0..2), bone_group_pcp, recall@500).
    """
    correct_parts = np.zeros(num_actors)
    total_parts = np.zeros(num_actors)
    bone_correct_parts = np.zeros((num_actors, 10))
    total_gt = 0
    match_gt = 0

    for pred_all, gts in zip(preds, gt_per_frame):
        pred = pred_all[pred_all[:, 0, 3] >= 0, :, :3]
        if len(pred) == 0:
            for person in range(num_actors):
                gt = gts[person]
                if gt is None or len(gt) == 0:
                    continue
                total_gt += 1
                total_parts[person] += len(PCP_LIMBS) + 1
            continue
        for person in range(num_actors):
            gt = gts[person]
            if gt is None or len(gt) == 0:
                continue
            gt = np.asarray(gt, dtype=np.float64)
            mpjpes = np.mean(np.sqrt(np.sum(
                (gt[np.newaxis] - pred) ** 2, axis=-1)), axis=-1)
            min_n = int(np.argmin(mpjpes))
            if float(np.min(mpjpes)) < recall_threshold:
                match_gt += 1
            total_gt += 1

            for j, (a, b) in enumerate(PCP_LIMBS):
                total_parts[person] += 1
                err_s = np.linalg.norm(pred[min_n, a] - gt[a])
                err_e = np.linalg.norm(pred[min_n, b] - gt[b])
                limb_len = np.linalg.norm(gt[a] - gt[b])
                if (err_s + err_e) / 2.0 <= alpha * limb_len:
                    correct_parts[person] += 1
                    bone_correct_parts[person, j] += 1
            # torso: mid-hip to joint 12 (shelf.py:310-318)
            pred_hip = (pred[min_n, 2] + pred[min_n, 3]) / 2.0
            gt_hip = (gt[2] + gt[3]) / 2.0
            total_parts[person] += 1
            err_s = np.linalg.norm(pred_hip - gt_hip)
            err_e = np.linalg.norm(pred[min_n, 12] - gt[12])
            limb_len = np.linalg.norm(gt_hip - gt[12])
            if (err_s + err_e) / 2.0 <= alpha * limb_len:
                correct_parts[person] += 1
                bone_correct_parts[person, 9] += 1

    actor_pcp = correct_parts / (total_parts + 1e-8)
    avg_pcp = float(np.mean(actor_pcp[:3]))
    bone_person_pcp = OrderedDict()
    for k, v in PCP_BONE_GROUPS.items():
        bone_person_pcp[k] = (np.sum(bone_correct_parts[:, v], axis=-1)
                              / (total_parts / 10 * len(v) + 1e-8))
    return actor_pcp, avg_pcp, bone_person_pcp, match_gt / (total_gt + 1e-8)
