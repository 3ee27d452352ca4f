"""The two decoder options the repo's configs set, in the port against the
JAX package on a toy config (tools/make_golden.py's widths, ResNet-18,
dropout 0), the same weights carried across by port_state_dict_from_jax
and the same synthetic batch:

  * DECODER.clamp_refs_to_space (configs/synthetic_ap_ablation.yaml): each
    layer's next-layer reference points clipped to the capture space. The
    space is shrunk to 2 x 2 x 0.8 m here, so that the first layer's
    triangulations do leave the box and the clip changes what the second
    layer sees;
  * DECODER.convert_joint_format_indices (configs/shelf_campus/*.yaml):
    the outputs reordered from Panoptic's 15 joints to Shelf's 14, the
    targets in that 14-joint format; with the gt match (match_queries
    reindexes the initial poses) and without it, with the init loss on
    (its initial poses are reindexed).

For each: every layer's forward output at the golden tolerance classes
(logits rtol 1e-3 / atol 2e-3, 2D atol 0.5 px, 3D p99 < 2 mm, max < 6 mm);
one training step's losses at rtol 1e-4 (the port's make_train_step
metrics against JAX's training forward and criterion on the same
weights); and the configs that set them building through build_model.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import make_golden  # noqa: E402

from mvgformer_tpu.core import criterion as jcrit  # noqa: E402
from mvgformer_tpu.data.datasets import PANOPTIC_TO_SHELF14  # noqa: E402
from mvgformer_tpu.data.synthetic import make_batch as jax_make_batch  # noqa: E402
from mvgformer_tpu.models.mvgformer import MVGFormer as JMVGFormer  # noqa: E402
from mvgformer_tpu_torch.config import load_config  # noqa: E402
from mvgformer_tpu_torch.core import train  # noqa: E402
from mvgformer_tpu_torch.data.synthetic import batch_from_jax  # noqa: E402
from mvgformer_tpu_torch.models import build_model  # noqa: E402
from mvgformer_tpu_torch.models.mvgformer import MVGFormer  # noqa: E402
from mvgformer_tpu_torch.utils.jax_convert import port_state_dict_from_jax  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

THRESHOLD = 0.1
CASES = {
    "clamp_refs_to_space": {
        "DECODER.clamp_refs_to_space": True,
        "MULTI_PERSON.SPACE_SIZE": [2000.0, 2000.0, 800.0]},
    "convert_joint_format_indices": {
        "DECODER.convert_joint_format_indices": PANOPTIC_TO_SHELF14},
    "convert_joint_format_indices_init_loss": {
        "DECODER.convert_joint_format_indices": PANOPTIC_TO_SHELF14,
        "DECODER.gt_match": False, "DECODER.loss_weight_init": 1.0},
}


def _cfg(overrides):
    cfg = make_golden.toy_cfg(topk=None, solver="eigh")
    cfg.POSE_RESNET.NUM_LAYERS = 18
    cfg.DECODER.dropout = 0.0
    for key, val in overrides.items():
        section, name = key.split(".")
        setattr(getattr(cfg, section), name, val)
    return cfg


def _batch(cfg):
    """A JAX batch; in the 14-joint format where the outputs are."""
    jb = jax_make_batch(cfg, batch_size=1, seed=3, num_people=2)
    cji = cfg.DECODER.convert_joint_format_indices
    if cji is None:
        return jb
    idx = np.asarray(cji)
    tg, vd = jb.targets, jb.view_data
    tg = tg.replace(joints_3d=tg.joints_3d[:, :, idx],
                    joints_3d_vis=tg.joints_3d_vis[:, :, idx])
    return jb.replace(targets=tg, view_data=vd.replace(
        joints_vis_2d=vd.joints_vis_2d[..., idx]))


def _jax_run(cfg, jb):
    """JAX's initial variables, serving outputs and one training forward's
    losses (the step's metrics, before its update)."""
    jm = JMVGFormer(cfg=cfg)

    @jax.jit
    def run(key, batch):
        variables = jm.init(key, batch)
        outs = jm.apply(variables, batch, threshold=THRESHOLD)
        init_refs = jm.initial_reference_points_static(1)
        match = jcrit.match_queries(cfg, init_refs, batch)
        gt_match = cfg.DECODER.gt_match
        touts = jm.apply(variables, batch,
                         query_mask=match.query_mask if gt_match else None,
                         train=True, rngs={"dropout": jax.random.PRNGKey(1)})
        losses = jcrit.compute_losses(cfg, touts, batch,
                                      match if gt_match else None,
                                      init_reference=init_refs)
        return variables, outs, losses

    return jax.tree_util.tree_map(np.asarray,
                                  run(jax.random.PRNGKey(0), jb))


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    cfg = _cfg(CASES[request.param])
    jb = _batch(cfg)
    variables, outs, losses = _jax_run(cfg, jb)
    model = MVGFormer(cfg, device="cpu")
    model.load_state_dict(port_state_dict_from_jax(variables, cfg))
    return dict(name=request.param, cfg=cfg, batch=batch_from_jax(jb),
                outs=outs, losses=losses, model=model)


def _assert_golden_classes(got, want):
    np.testing.assert_allclose(got["pred_logits"], want["pred_logits"],
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(got["pred_poses_2d"], want["pred_poses_2d"],
                               rtol=1e-3, atol=0.5)
    err = np.abs(got["pred_poses"] - want["pred_poses"])
    assert np.percentile(err, 99) < 2.0, np.percentile(err, 99)
    assert err.max() < 6.0, err.max()


def test_forward_matches_jax(case):
    model = case["model"]
    model.eval()
    with torch.no_grad():
        outs = model(case["batch"], threshold=THRESHOLD)
    assert len(outs) == len(case["outs"])
    J = 14 if case["cfg"].DECODER.convert_joint_format_indices else 15
    Q = case["cfg"].DECODER.num_instance
    for got, want in zip(outs, case["outs"]):
        assert tuple(got["pred_poses"].shape) == (1, Q * J, 3)
        _assert_golden_classes({k: v.numpy() for k, v in got.items()
                                if k in want}, want)
    if case["name"] == "clamp_refs_to_space":
        # the clip is active: some first-layer refs leave the box
        cfg = case["cfg"]
        c = np.asarray(cfg.MULTI_PERSON.SPACE_CENTER)
        s = np.asarray(cfg.MULTI_PERSON.SPACE_SIZE)
        refs = outs[0]["pred_poses"].numpy().reshape(-1, 3)
        nonzero = np.abs(refs).sum(-1) > 0
        out_of_box = (np.abs(refs - c) > 0.75 * s).any(-1) & nonzero
        assert out_of_box.any()


def test_train_step_losses_match_jax(case):
    model = case["model"]
    cfg = case["cfg"]
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    state, tx = train.create_train_state(cfg, model)
    _, metrics = train.make_train_step(cfg, model, tx)(
        state, case["batch"], torch.Generator().manual_seed(0))
    model.load_state_dict(sd)  # the forward test may run after this one
    want = case["losses"]
    assert set(want) <= set(metrics)
    for k, v in want.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    if not cfg.DECODER.gt_match:
        assert float(metrics["loss_init"]) > 0


@pytest.mark.parametrize("path", ["configs/synthetic_ap_ablation.yaml",
                                  "configs/shelf_campus/"
                                  "shelf_knn5-lr4-q1024.yaml",
                                  "configs/shelf_campus/"
                                  "campus_knn5-lr4-q1024.yaml"])
def test_check_supported_accepts_the_configs(path):
    """The configs that set the two options build through build_model
    (check_supported, which once refused options, is gone)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, path))
    assert (cfg.DECODER.clamp_refs_to_space
            or cfg.DECODER.convert_joint_format_indices is not None)
    model = build_model(cfg, device="cpu")
    assert isinstance(model, MVGFormer)
    if cfg.DECODER.clamp_refs_to_space:
        assert model.decoder.ref_clamp_box is not None
