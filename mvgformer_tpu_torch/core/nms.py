"""Pose NMS on the host, in numpy: the port's own copy of
`mvgformer_tpu/core/nms.py`.

The original repo's eval post-processing is an order-sensitive greedy NMS
(its lib/core/nms.py:210-284, vendored from mmpose's `nearby_joints_nms`,
Apache-2.0); it runs on the host after the predictions are collected, and
is copied line for line, since a rewrite could silently change the
reported numbers. One departure, where the original stops with an
error: a pose whose joints all lie at one point (zero pose area, as the
DLT's degenerate-system guard gives a query outside every view) or that
holds a non-finite joint is close to no pose, not even itself, and the
original's argmax over an empty cluster raises; here it is its own
cluster. Wherever the original returns, the two return the same.
"""

from __future__ import annotations

import numpy as np


def nearby_joints_nms(kpts_db: np.ndarray, dist_thr: float,
                      num_nearby_joints_thr: int | None = None,
                      max_dets: int = -1) -> list:
    """Greedy pose NMS keeping the highest-score instance per cluster.

    kpts_db: (N, J, 5) poses as [x, y, z, flag, score] (the combined-input
    format, nms.py:237-239). Two instances are "close" when more than
    `num_nearby_joints_thr` of their joints are within a pose-area-scaled
    distance (nms.py:254-265). Returns kept indices.
    """
    assert dist_thr > 0, "`dist_thr` must be greater than 0."
    if len(kpts_db) == 0:
        return []

    scores = np.array(kpts_db[:, 0, 4])
    kpts = np.array(kpts_db[:, :, :3])

    num_people, num_joints, _ = kpts.shape
    if num_nearby_joints_thr is None:
        num_nearby_joints_thr = num_joints // 2
    assert num_nearby_joints_thr < num_joints

    pose_area = kpts.max(axis=1) - kpts.min(axis=1)
    pose_area = np.sqrt(np.power(pose_area, 2).sum(axis=1))
    pose_area = pose_area.reshape(num_people, 1, 1)
    pose_area = np.tile(pose_area, (num_people, num_joints))
    close_dist_thr = pose_area * dist_thr

    instance_dist = kpts[:, None] - kpts
    instance_dist = np.sqrt(np.power(instance_dist, 2).sum(axis=3))
    close_instance_num = (instance_dist < close_dist_thr).sum(2)
    close_instance = close_instance_num > num_nearby_joints_thr

    ignored, keep = set(), []
    for i in np.argsort(scores)[::-1]:
        if i in ignored:
            continue
        keep_inds = close_instance[i].nonzero()[0]
        if not len(keep_inds):  # a collapsed or non-finite pose
            keep_inds = np.array([i])
        keep_ind = keep_inds[np.argmax(scores[keep_inds])]
        if keep_ind not in ignored:
            keep.append(keep_ind)
            ignored = ignored.union(set(keep_inds))

    if max_dets > 0 and len(keep) > max_dets:
        sub = np.argsort(scores[keep])[-1:-max_dets - 1:-1]
        keep = [keep[i] for i in sub]
    return keep


def apply_pose_nms(preds: np.ndarray, dist_thr: float = 0.3,
                   num_nearby_joints_thr: int = 7) -> np.ndarray:
    """Filter one frame's (Q, J, 5) predictions: keep flagged (score>thr)
    poses, then NMS — the eval operating point (run/validate_3d.py:222-224,
    run/train_3d.py:334-335)."""
    flagged = preds[preds[:, 0, 3] >= 0]
    if len(flagged) == 0:
        return flagged
    keep = nearby_joints_nms(flagged, dist_thr, num_nearby_joints_thr)
    return flagged[keep]
