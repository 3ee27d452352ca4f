"""The port's evaluation and pose NMS (numpy copies in
mvgformer_tpu_torch/core/) against the JAX package's on the same
predictions, made from a seed with numpy: near-duplicate poses around
posed people, noise of several sizes, false positives, flags below the
threshold, missing actors. Every result must be equal, exactly. Template:
tests/test_eval.py."""

import numpy as np
import pytest

from mvgformer_tpu.core import evaluate as jeval
from mvgformer_tpu.core import nms as jnms
from mvgformer_tpu.data.synthetic import make_people
from mvgformer_tpu_torch.core import evaluate as teval
from mvgformer_tpu_torch.core import nms as tnms

SEEDS = [0, 1, 2]


def _frame_preds(rng, gt, n_dup=2, n_fp=2, noise=30.0):
    """(N, J, 5) predictions for one frame: each gt person with noise, a
    few near-duplicates with lower scores, some far false positives, and
    random flags and scores."""
    J = gt.shape[1]
    poses = [gt + rng.normal(0, noise, gt.shape)]
    poses.append(gt[:n_dup] + rng.normal(0, noise / 2, gt[:n_dup].shape))
    poses.append(rng.uniform(-3000, 3000, (n_fp, J, 3)))
    poses = np.concatenate(poses).astype(np.float32)
    n = len(poses)
    out = np.zeros((n, J, 5), np.float32)
    out[:, :, :3] = poses
    out[:, :, 3] = np.where(rng.uniform(size=(n, 1)) < 0.8, 0.0, -1.0)
    out[:, :, 4] = rng.uniform(0.05, 0.95, (n, 1))
    return out


def _scenes(seed, frames=6, J=15):
    rng = np.random.RandomState(seed)
    gts = [make_people(1 + (i % 4), seed=100 * seed + i)[:, :J]
           for i in range(frames)]
    preds = [_frame_preds(rng, g, noise=rng.choice([5.0, 30.0, 120.0]))
             for g in gts]
    vis = [(rng.uniform(size=g.shape[:2]) > 0.1).astype(np.float32)
           for g in gts]
    return rng, gts, preds, vis


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dist_thr,nearby", [(0.3, 7), (0.05, 3),
                                             (0.8, 13)])
def test_nearby_joints_nms_matches(seed, dist_thr, nearby):
    _, _, preds, _ = _scenes(seed)
    for p in preds:
        assert (list(tnms.nearby_joints_nms(p, dist_thr, nearby))
                == list(jnms.nearby_joints_nms(p, dist_thr, nearby)))
        np.testing.assert_array_equal(
            tnms.apply_pose_nms(p, dist_thr, nearby),
            jnms.apply_pose_nms(p, dist_thr, nearby))
    assert tnms.nearby_joints_nms(preds[0][:0], 0.3) == []


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("method", ["score_sort", "mpjpe_sort"])
@pytest.mark.parametrize("with_vis", [False, True])
def test_evaluate_ap_mpjpe_matches(seed, method, with_vis):
    _, gts, preds, vis = _scenes(seed)
    nmsed = [jnms.apply_pose_nms(p) for p in preds]
    v = vis if with_vis else None
    got = teval.evaluate_ap_mpjpe(nmsed, gts, v, method=method)
    want = jeval.evaluate_ap_mpjpe(nmsed, gts, v, method=method)
    assert got == want
    assert 0.0 < want["recall@500"] <= 1.0


@pytest.mark.parametrize("seed", SEEDS)
def test_evaluate_by_observability_matches(seed):
    rng, gts, preds, vis3d = _scenes(seed)
    V = 5
    vis2d = [(rng.uniform(size=(V,) + g.shape[:2]) > 0.3).astype(np.float32)
             for g in gts]
    got = teval.evaluate_by_observability(preds, gts, vis2d, num_views=V,
                                          gt_vis3d=vis3d)
    want = jeval.evaluate_by_observability(preds, gts, vis2d, num_views=V,
                                           gt_vis3d=vis3d)
    assert got == want and len(want) > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_evaluate_pcp_matches(seed):
    rng, gts, preds, _ = _scenes(seed, J=14)
    actors = 3
    gt_frames = []
    for i, g in enumerate(gts):
        # each actor present where the frame has that many people; one
        # frame with nobody predicted
        gt_frames.append([g[a] if a < len(g) else np.zeros((0,))
                          for a in range(actors)])
    preds[1] = preds[1][:0]
    got = teval.evaluate_pcp(preds, gt_frames, actors)
    want = jeval.evaluate_pcp(preds, gt_frames, actors)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and got[3] == want[3]
    assert list(got[2]) == list(want[2])
    for k in want[2]:
        np.testing.assert_array_equal(got[2][k], want[2][k])
