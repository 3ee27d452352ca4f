"""The DQ model's options in the port against the JAX package, on the toy
config of tests/torch_parity.py (the same weights carried across by
port_state_dict_from_jax, the same synthetic batch). The feature updates
MLP0, MLPr and mean, init_self_attention, bayesian_update,
share_layer_weights and the reference inits are in
test_torch_reference_inits.py; here:

  * feature_update_method 'attention' (its value is tgt) with
    triangulation_method 'st', 'attention_embed' with init_ref_method
    'query_adapt', and 'attention_embed_direct': every layer's serving
    outputs at the golden classes (logits rtol 1e-3 / atol 2e-3, 2D atol
    0.5 px, 3D p99 < 2 mm, max < 6 mm) and one make_train_step's losses
    (rtol 1e-4); for attention_embed with query_adapt its gradients too
    (1e-3 of a leaf's largest);
  * the refusals JAX has (build_model's acceptance of every value JAX
    accepts is in tests/test_torch_reference_inits.py): an unknown init or
    feature update,
    voxcel_pose_base without predictions or with a slot count other than
    the query count, ProjAttn's ray modes in the DQ model (the MvP
    model's unknown fusion and TRANSFORMER: tests/test_torch_mvp.py);
  * the two training switches the port accepts and runs on its one path:
    TRAIN.SAMPLE_CHUNKS 2 (divides the 240 queries) and 7 (does not)
    against no chunks, and PARALLEL.REMAT_POLICY 'save_sampled' against
    'full' at dropout 0.1: the same losses and gradients bit for bit.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from mvgformer_tpu.data.synthetic import make_batch as jax_make_batch
from mvgformer_tpu.models.mvgformer import MVGFormer as JMVGFormer
from mvgformer_tpu_torch.core import train
from mvgformer_tpu_torch.data.synthetic import make_batch
from mvgformer_tpu_torch.models.mvgformer import MVGFormer
from torch_one_thread import one_torch_thread  # noqa: F401
from torch_parity import (batch_from_jax, check_forward, check_train_step,
                          jax_batch, make_case, toy_cfg)

CASES = {
    "attention_st": {
        "DECODER.feature_update_method": "attention",
        "DECODER.triangulation_method": "st"},
    "attention_embed_query_adapt": {
        "DECODER.feature_update_method": "attention_embed",
        "DECODER.init_ref_method": "query_adapt"},
    "attention_embed_direct": {
        "DECODER.feature_update_method": "attention_embed_direct"},
}
WITH_GRADS = "attention_embed_query_adapt"


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return make_case(request.param, CASES[request.param],
                     grads=request.param == WITH_GRADS)


def test_forward_matches_jax(case):
    check_forward(case)


def test_train_step_matches_jax(case):
    check_train_step(case)


def _raises_in_both(cfg, jb, exc=ValueError, match=None, **call):
    """JAX raises tracing the model on jb, the port building or calling
    it."""
    with pytest.raises(exc, match=match):
        jax.eval_shape(lambda: JMVGFormer(cfg=cfg).init(
            {"params": jax.random.PRNGKey(0),
             "init_ref": jax.random.PRNGKey(1)}, jb, **call))
    with pytest.raises(exc, match=match):
        with torch.no_grad():
            MVGFormer(cfg, device="cpu")(batch_from_jax(jb), **call)


@pytest.mark.parametrize("overrides,match", [
    ({"DECODER.init_ref_method": "random"}, "init_ref_method"),
    ({"DECODER.feature_update_method": "GRU"}, "feature_update_method"),
    ({"DECODER.init_ref_method": "voxcel_pose_base"}, "voxelpose"),
    ({"DECODER.init_ref_method": "voxcel_pose_base",
      "DECODER.num_instance": 6}, "MAX_PEOPLE_NUM"),
])
def test_refusals_match_jax(overrides, match):
    cfg = toy_cfg(overrides)
    jb = jax_make_batch(cfg, batch_size=1, seed=0, num_people=1)
    if "num_instance" in str(overrides):
        # predictions in MAX_PEOPLE_NUM = 4 slots for 6 queries
        jb = jax_batch(toy_cfg({"DECODER.init_ref_method":
                                 "voxcel_pose_base"}))
    _raises_in_both(cfg, jb, match=match)


@pytest.mark.parametrize("mode", ["use_rayconv", "use_2d_coordconv"])
def test_ray_modes_refused_by_the_dq_model(mode):
    """JAX's DQ layer hands ProjAttn no rays, and ProjAttn asserts."""
    cfg = toy_cfg({"DECODER.projattn_posembed_mode": mode,
                   "DECODER.num_instance": 4})
    jb = jax_make_batch(cfg, batch_size=1, seed=0, num_people=1)
    with pytest.raises(AssertionError):
        jax.eval_shape(lambda: JMVGFormer(cfg=cfg).init(
            jax.random.PRNGKey(0), jb))
    with pytest.raises(ValueError, match="camera"):
        MVGFormer(cfg, device="cpu")


# --- the port's training switches against each other ----------------------

def _step(cfg, sd, batch, seed=7):
    model = MVGFormer(cfg, device="cpu")
    model.load_state_dict(sd)
    state, tx = train.create_train_state(cfg, model)
    _, metrics = train.make_train_step(cfg, model, tx)(
        state, batch, torch.Generator().manual_seed(seed))
    return metrics, {k: p.grad for k, p in model.named_parameters()
                     if p.grad is not None}


@pytest.fixture(scope="module")
def switch_base():
    cfg = toy_cfg({"DECODER.dropout": 0.1})
    cfg.DECODER.triangulation_method = "jacobi"
    model = MVGFormer(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    # random offsets / weights kernels: every sample lands elsewhere
    sd = copy.deepcopy(model.state_dict())
    g = torch.Generator().manual_seed(1)
    for k in sd:
        if "sampling_offsets.weight" in k or "attention_weights.weight" in k:
            sd[k] = 0.05 * torch.randn(sd[k].shape, generator=g)
    batch = make_batch(cfg, seed=2, num_people=2, device="cpu")
    return cfg, sd, batch, _step(cfg, sd, batch)


@pytest.mark.parametrize("section,key,value", [
    ("TRAIN", "SAMPLE_CHUNKS", 2),
    ("TRAIN", "SAMPLE_CHUNKS", 7),
    ("PARALLEL", "REMAT_POLICY", "save_sampled"),
])
def test_training_switch_equals_default(switch_base, section, key, value):
    cfg, sd, batch, (want_m, want_g) = switch_base
    cfg = copy.deepcopy(cfg)
    setattr(getattr(cfg, section), key, value)
    metrics, grads = _step(cfg, sd, batch)
    assert set(metrics) == set(want_m)
    for k in want_m:
        torch.testing.assert_close(metrics[k], want_m[k], rtol=0, atol=0,
                                   msg=k)
    assert grads.keys() == want_g.keys() and len(grads) > 40
    for k, g in grads.items():
        torch.testing.assert_close(g, want_g[k], rtol=0, atol=0, msg=k)
