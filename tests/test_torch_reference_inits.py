"""The DQ model's reference inits and decoder-layer options in the port
against the JAX package, on the toy config of tests/torch_parity.py (the
same weights carried across by port_state_dict_from_jax, the same synthetic
batch), three JAX models covering each a feature update, a layer option and
an init:

  * MLP0 with bayesian_update and init_ref_method 'gt_noise' at std 0
    (init_ref_method_value 0: the std, not the default 100);
  * MLPr with init_self_attention and 'voxcel_pose_base' (VoxelPose's
    predictions attached to the batch, num_instance = MAX_PEOPLE_NUM);
  * mean (over the query axis) with share_layer_weights and
    'query_adapt_center';

each: every layer's serving outputs at the golden classes and one
make_train_step's losses (rtol 1e-4). Also: 'gt_noise' at std > 0 is
finite, of the right shape and drawn from the generator; a window plan
with a non-grid init raises.
"""

import pytest
import torch

from mvgformer_tpu_torch.data.synthetic import make_batch
from mvgformer_tpu_torch.models.mvgformer import (MVGFormer,
                                                  build_layer1_window_plan)
from torch_one_thread import one_torch_thread  # noqa: F401
from torch_parity import (THRESHOLD, check_forward, check_train_step,
                          make_case, toy_cfg)

CASES = {
    "MLP0_bayesian_update_gt_noise": {
        "DECODER.feature_update_method": "MLP0",
        "DECODER.bayesian_update": True,
        "DECODER.init_ref_method": "gt_noise",
        "DECODER.init_ref_method_value": 0},
    "MLPr_init_self_attention_voxcel_pose_base": {
        "DECODER.feature_update_method": "MLPr",
        "DECODER.init_self_attention": True,
        "DECODER.init_ref_method": "voxcel_pose_base",
        "DECODER.num_instance": 8, "MULTI_PERSON.MAX_PEOPLE_NUM": 8},
    "mean_share_layer_weights_query_adapt_center": {
        "DECODER.feature_update_method": "mean",
        "DECODER.share_layer_weights": True,
        "DECODER.init_ref_method": "query_adapt_center"},
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return make_case(request.param, CASES[request.param])


def test_forward_matches_jax(case):
    check_forward(case)
    if "share_layer_weights" in case["name"]:
        names = dict(case["model"].named_parameters())
        assert not any(k.startswith("decoder.layers.") for k in names)
        assert any(k.startswith("decoder.layer_shared.") for k in names)


def test_train_step_matches_jax(case):
    check_train_step(case)


def test_gt_noise_draws_from_the_generator():
    cfg = toy_cfg({"DECODER.init_ref_method": "gt_noise",
                   "DECODER.init_ref_method_value": 50.0})
    model = MVGFormer(cfg, device="cpu")
    batch = make_batch(cfg, seed=1, num_people=2, device="cpu")
    runs = []
    for seed in (0, 0, 1):
        with torch.no_grad():
            outs = model(batch, threshold=THRESHOLD,
                         generator=torch.Generator().manual_seed(seed))
        runs.append(outs[-1]["pred_poses"])
    Q, J = cfg.DECODER.num_instance, cfg.DECODER.num_keypoints
    assert runs[0].shape == (1, Q * J, 3)
    assert all(torch.isfinite(r).all() for r in runs)
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0],
                                                             runs[2])


def test_window_plan_needs_the_grid_init():
    cfg = toy_cfg({"DECODER.init_ref_method": "query_adapt"})
    batch = make_batch(cfg, seed=0, num_people=1, device="cpu")
    plan = build_layer1_window_plan(cfg, batch.view_data, device="cpu")
    with torch.no_grad(), pytest.raises(ValueError, match="sample_space"):
        MVGFormer(cfg, device="cpu")(batch, window_plan=plan)
