"""The port's matcher (models/matcher.py) and criterion (core/criterion.py)
against the JAX package's on the same arrays:

  * KNN, threshold ('multiple') and Hungarian matching give the same
    indices and masks, on costs full of ties (integer-valued: both sides
    take the lowest query index first among equal costs);
  * match_queries on the initial query grid of a toy config;
  * every loss term of compute_losses at rtol 1e-5 (float32 sums of the
    same terms in another order), on fixed layer outputs near the ground
    truth and a synthetic batch, over the loss and matching options.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import make_golden  # noqa: E402

from mvgformer_tpu.core import criterion as jcrit  # noqa: E402
from mvgformer_tpu.data.synthetic import make_batch as jax_make_batch  # noqa: E402
from mvgformer_tpu.models import matcher as jmatch  # noqa: E402
from mvgformer_tpu.models.mvgformer import sample_space_reference_points  # noqa: E402
from mvgformer_tpu_torch.core import criterion  # noqa: E402
from mvgformer_tpu_torch.data.synthetic import batch_from_jax  # noqa: E402
from mvgformer_tpu_torch.models import matcher  # noqa: E402
from mvgformer_tpu_torch.models.mvgformer import load_tpose  # noqa: E402


def _tied_cost(seed, B=2, Q=24, M=4):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 5, (B, Q, M)).astype(np.float32)


def _assert_match_equal(got, want):
    np.testing.assert_array_equal(got.query_idx.numpy(),
                                  np.asarray(want.query_idx))
    np.testing.assert_array_equal(got.gt_valid.numpy(),
                                  np.asarray(want.gt_valid))
    np.testing.assert_array_equal(got.query_mask.numpy(),
                                  np.asarray(want.query_mask))
    assert (got.pair_valid is None) == (want.pair_valid is None)
    if got.pair_valid is not None:
        np.testing.assert_array_equal(got.pair_valid.numpy(),
                                      np.asarray(want.pair_valid))


NUM_PERSON = np.array([3, 1], np.int32)


@pytest.mark.parametrize("k", [1, 5])
def test_knn_match_equal_with_ties(k):
    cost = _tied_cost(k)
    want = jmatch.knn_match(jnp.asarray(cost), jnp.asarray(NUM_PERSON), k)
    got = matcher.knn_match(torch.from_numpy(cost),
                            torch.from_numpy(NUM_PERSON), k)
    _assert_match_equal(got, want)


@pytest.mark.parametrize("thresh", [1.5, 3.5])
def test_threshold_match_equal_with_ties(thresh):
    cost = _tied_cost(7)
    want = jmatch.threshold_match(jnp.asarray(cost), jnp.asarray(NUM_PERSON),
                                  thresh, k_cap=8)
    got = matcher.threshold_match(torch.from_numpy(cost),
                                  torch.from_numpy(NUM_PERSON), thresh,
                                  k_cap=8)
    _assert_match_equal(got, want)


def test_hungarian_match_equal():
    cost = np.random.RandomState(3).rand(2, 24, 4).astype(np.float32)
    pairs_want = jmatch.hungarian_match_host(cost, NUM_PERSON)
    pairs = matcher.hungarian_match_host(cost, NUM_PERSON)
    for (q, g), (qw, gw) in zip(pairs, pairs_want):
        np.testing.assert_array_equal(q, qw)
        np.testing.assert_array_equal(g, gw)
    _assert_match_equal(
        matcher.hungarian_to_match_result(pairs, 2, 24, 4),
        jmatch.hungarian_to_match_result(pairs_want, 2, 24, 4))
    _assert_match_equal(
        matcher.hungarian_match(torch.from_numpy(cost),
                                torch.from_numpy(NUM_PERSON)),
        jmatch.hungarian_match_callback(jnp.asarray(cost),
                                        jnp.asarray(NUM_PERSON)))


def test_costs_equal():
    rng = np.random.RandomState(4)
    pred = rng.randn(2, 6, 15, 3).astype(np.float32) * 100
    gt = rng.randn(2, 3, 15, 3).astype(np.float32) * 100
    np.testing.assert_allclose(
        matcher.pose_l1_cost(torch.from_numpy(pred),
                             torch.from_numpy(gt)).numpy(),
        np.asarray(jmatch.pose_l1_cost(jnp.asarray(pred), jnp.asarray(gt))),
        rtol=1e-6)
    prob = rng.rand(2, 6).astype(np.float32)
    np.testing.assert_allclose(
        matcher.focal_class_cost(torch.from_numpy(prob)).numpy(),
        np.asarray(jmatch.focal_class_cost(jnp.asarray(prob))), rtol=1e-6,
        atol=1e-7)


def _cfg(**overrides):
    cfg = make_golden.toy_cfg(topk=None, solver="jacobi")
    for key, val in overrides.items():
        section, name = key.split(".")
        setattr(getattr(cfg, section), name, val)
    return cfg


@pytest.fixture(scope="module")
def batch_and_outputs():
    """A synthetic batch (3 people of 4 slots) and two decoder layers'
    outputs: poses within ~0.2 m of the init grid, some queries on the
    people, random logits and 2D."""
    cfg = _cfg()
    jb = jax_make_batch(cfg, batch_size=2, seed=5, num_people=3)
    rng = np.random.RandomState(9)
    Q, J = cfg.DECODER.num_instance, cfg.DECODER.num_keypoints
    V = cfg.DATASET.CAMERA_NUM
    init = sample_space_reference_points(
        Q, load_tpose(cfg.DECODER.t_pose_dir), cfg.MULTI_PERSON.SPACE_SIZE,
        cfg.MULTI_PERSON.SPACE_CENTER).reshape(Q, J, 3)
    gt = np.asarray(jb.targets.joints_3d)
    outs = []
    for _ in range(2):
        poses = np.broadcast_to(init, (2, Q, J, 3)).copy()
        poses += rng.randn(2, Q, J, 3).astype(np.float32) * 200
        poses[:, 3:6] = gt[:, :3] + rng.randn(2, 3, J, 3) * 30
        outs.append({
            "pred_logits": rng.randn(2, Q, 2).astype(np.float32),
            "pred_poses": poses.reshape(2, Q * J, 3).astype(np.float32),
            "pred_poses_2d": rng.uniform(0, 96, (2, V, Q * J, 2)).astype(
                np.float32),
        })
    init_refs = np.broadcast_to(init.reshape(1, Q * J, 3),
                                (2, Q * J, 3)).copy()
    return jb, outs, init_refs


LOSS_CASES = {
    "knn_gt_match": {},
    "knn_per_layer": {"DECODER.gt_match": False},
    "multiple": {"DECODER.match_method": "multiple",
                 "DECODER.match_method_value": 60.0},
    "multiple_per_layer": {"DECODER.match_method": "multiple",
                           "DECODER.match_method_value": 60.0,
                           "DECODER.gt_match": False},
    "hungarian": {"DECODER.match_method": "hungarian"},
    "l2_perbone_exp": {"DECODER.loss_joint_type": "l2",
                       "DECODER.use_loss_pose_perbone": True,
                       "DECODER.decay_method": "exp"},
    "mpjpe_perprojection_linear": {
        "DECODER.loss_joint_type": "mpjpe",
        "DECODER.use_loss_pose_perprojection": True,
        "DECODER.decay_method": "linear"},
    "ce_match_last": {"DECODER.use_ce_match": True,
                      "DECODER.decay_method": "last"},
    "init_loss": {"DECODER.gt_match": False,
                  "DECODER.loss_weight_init": 1.0},
    "replicas": {"num_replicas": 8},
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_compute_losses_match_jax(batch_and_outputs, case):
    overrides = dict(LOSS_CASES[case])
    num_replicas = overrides.pop("num_replicas", 1)
    cfg = _cfg(**overrides)
    jb, outs, init_refs = batch_and_outputs
    jmatch_q = jcrit.match_queries(cfg, jnp.asarray(init_refs), jb)
    want = jcrit.compute_losses(
        cfg, [{k: jnp.asarray(v) for k, v in o.items()} for o in outs], jb,
        jmatch_q if cfg.DECODER.gt_match else None,
        init_reference=jnp.asarray(init_refs), num_replicas=num_replicas)
    batch = batch_from_jax(jb)
    match = criterion.match_queries(cfg, torch.from_numpy(init_refs), batch)
    _assert_match_equal(match, jmatch_q)
    got = criterion.compute_losses(
        cfg, [{k: torch.from_numpy(v) for k, v in o.items()} for o in outs],
        batch, match if cfg.DECODER.gt_match else None,
        init_reference=torch.from_numpy(init_refs),
        num_replicas=num_replicas)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


def test_layer_decay_weights_equal():
    for method in ("none", "linear", "exp", "last"):
        np.testing.assert_allclose(
            criterion.layer_decay_weights(method, 4).numpy(),
            np.asarray(jcrit.layer_decay_weights(method, 4)), rtol=1e-7)


def test_focal_loss_equal():
    rng = np.random.RandomState(2)
    logits = rng.randn(3, 7, 2).astype(np.float32) * 4
    targets = (rng.rand(3, 7, 2) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        criterion.sigmoid_focal_loss(torch.from_numpy(logits),
                                     torch.from_numpy(targets)).numpy(),
        np.asarray(jcrit.sigmoid_focal_loss(jnp.asarray(logits),
                                            jnp.asarray(targets))),
        rtol=1e-6, atol=1e-7)


def test_gather_pairs_equal():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, 3, 2).astype(np.float32)
    idx = rng.randint(0, 9, (2, 4, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        criterion._gather_pairs(torch.from_numpy(x),
                                torch.from_numpy(idx).long()).numpy(),
        np.asarray(jcrit._gather_pairs(jnp.asarray(x), jnp.asarray(idx))))


def test_match_outputs_refuses_hungarian(batch_and_outputs):
    jb, outs, _ = batch_and_outputs
    cfg = _cfg(**{"DECODER.match_method": "hungarian"})
    with pytest.raises(NotImplementedError):
        criterion.match_outputs(
            cfg, {k: torch.from_numpy(v) for k, v in outs[0].items()},
            batch_from_jax(jb))
