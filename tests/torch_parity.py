"""Shared helpers of the port's parity tests against the JAX package on the
toy DQ config (tools/make_golden.py's widths, ResNet-18, dropout 0, eigh
DLT): the config with overrides, one jitted JAX run (initial variables,
serving outputs, the training forward's losses and optionally their
gradient), the port's model on the same weights, and the golden tolerance
classes."""

import os
import sys

import jax
import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import make_golden  # noqa: E402

from mvgformer_tpu.core import criterion as jcrit  # noqa: E402
from mvgformer_tpu.data.synthetic import make_batch as jax_make_batch  # noqa: E402
from mvgformer_tpu.models.mvgformer import MVGFormer as JMVGFormer  # noqa: E402
from mvgformer_tpu_torch.core import train  # noqa: E402
from mvgformer_tpu_torch.data.synthetic import batch_from_jax  # noqa: E402
from mvgformer_tpu_torch.models.mvgformer import MVGFormer  # noqa: E402
from mvgformer_tpu_torch.utils.jax_convert import port_state_dict_from_jax  # noqa: E402

THRESHOLD = 0.1


def toy_cfg(overrides=None):
    """The toy DQ config with {'SECTION.key': value} overrides."""
    cfg = make_golden.toy_cfg(topk=None, solver="eigh")
    cfg.POSE_RESNET.NUM_LAYERS = 18
    cfg.DECODER.dropout = 0.0
    for key, val in (overrides or {}).items():
        section, name = key.split(".")
        setattr(getattr(cfg, section), name, val)
    return cfg


def jax_run(cfg, jb, grads=False):
    """JAX's variables, serving outputs (threshold THRESHOLD) and one
    training forward's losses with the gt match as make_train_step takes
    it, and with `grads` the losses' gradient; numpy leaves."""
    jm = JMVGFormer(cfg=cfg)
    rngs = {"init_ref": jax.random.PRNGKey(2)}

    def loss_fn(params, batch_stats, batch):
        init_refs = jm.initial_reference_points_static(1)
        match = jcrit.match_queries(cfg, init_refs, batch)
        gt_match = cfg.DECODER.gt_match
        touts = jm.apply({"params": params, "batch_stats": batch_stats},
                         batch,
                         query_mask=match.query_mask if gt_match else None,
                         train=True, rngs=dict(rngs, dropout=jax.random.
                                               PRNGKey(1)))
        losses = jcrit.compute_losses(cfg, touts, batch,
                                      match if gt_match else None,
                                      init_reference=init_refs)
        return losses["total"], losses

    @jax.jit
    def run(key, batch):
        variables = jm.init({"params": key, **rngs}, batch)
        outs = jm.apply(variables, batch, threshold=THRESHOLD, rngs=rngs)
        args = (variables["params"], variables["batch_stats"], batch)
        if grads:
            (_, losses), g = jax.value_and_grad(loss_fn, has_aux=True)(*args)
            return variables, outs, losses, g
        return variables, outs, loss_fn(*args)[1], None

    return jax.tree_util.tree_map(np.asarray, run(jax.random.PRNGKey(0), jb))


def port_model(cfg, variables):
    """The port's model on the CPU with JAX's weights."""
    model = MVGFormer(cfg, device="cpu")
    model.load_state_dict(port_state_dict_from_jax(variables, cfg))
    return model


def port_grads(cfg, variables, grads):
    """JAX's gradient tree under the port's parameter names."""
    return port_state_dict_from_jax(
        {"params": grads, "batch_stats": variables["batch_stats"]}, cfg)


def assert_golden_classes(got, want, keys=("pred_logits", "pred_poses",
                                           "pred_poses_2d")):
    """logits rtol 1e-3 / atol 2e-3, 2D atol 0.5 px, 3D p99 < 2 mm and max
    < 6 mm; got and want hold numpy arrays."""
    if "pred_logits" in keys:
        np.testing.assert_allclose(got["pred_logits"], want["pred_logits"],
                                   rtol=1e-3, atol=2e-3)
    if "pred_poses_2d" in keys:
        np.testing.assert_allclose(got["pred_poses_2d"],
                                   want["pred_poses_2d"], rtol=1e-3,
                                   atol=0.5)
    err = np.abs(got["pred_poses"] - want["pred_poses"])
    assert np.percentile(err, 99) < 2.0, np.percentile(err, 99)
    assert err.max() < 6.0, err.max()


def assert_grads_match(grads, want, min_checked=40):
    """Every trainable leaf within max|diff| <= 1e-3 * max|g_jax| + 1e-6;
    the frozen backbone takes none in the port."""
    checked = 0
    for name, g in grads.items():
        if name.startswith("backbone."):
            assert g is None, name
            continue
        w = want[name].numpy()
        if g is None:
            # a parameter the loss does not reach: JAX's gradient is zeros
            assert not np.any(w), name
            continue
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-3 * np.abs(w).max() + 1e-6, (name, err)
        checked += 1
    assert checked >= min_checked, checked


def jax_batch(cfg, seed=3):
    """JAX's synthetic batch (1 frame, 2 people); for voxcel_pose_base
    with VoxelPose's predictions attached: the targets moved by a few cm,
    one slot per query (num_instance = MAX_PEOPLE_NUM)."""
    jb = jax_make_batch(cfg, batch_size=1, seed=seed, num_people=2)
    if cfg.DECODER.init_ref_method == "voxcel_pose_base":
        rng = np.random.RandomState(seed)
        gt = np.asarray(jb.targets.joints_3d)
        vp = np.concatenate([gt + rng.normal(0, 30, gt.shape),
                             np.ones(gt.shape[:-1] + (2,))], -1)
        jb = jb.replace(targets=jb.targets.replace(
            voxelpose_pred=vp.astype(np.float32)))
    return jb


def make_case(name, overrides, grads=False):
    """A parity case: the JAX run of the toy config with `overrides` and
    the port's model on its weights."""
    cfg = toy_cfg(overrides)
    jb = jax_batch(cfg)
    variables, outs, losses, g = jax_run(cfg, jb, grads=grads)
    return dict(name=name, cfg=cfg, batch=batch_from_jax(jb), outs=outs,
                losses=losses, model=port_model(cfg, variables),
                grads=None if g is None else port_grads(cfg, variables, g))


def check_forward(case):
    """Every layer's serving outputs at the golden classes."""
    with torch.no_grad():
        outs = case["model"](case["batch"], threshold=THRESHOLD)
    assert len(outs) == len(case["outs"])
    for got, want in zip(outs, case["outs"]):
        assert_golden_classes({k: v.numpy() for k, v in got.items()}, want)
    return outs


def check_train_step(case):
    """One make_train_step's losses (rtol 1e-4) and, where the case has
    JAX's, gradients; the model's weights are restored after."""
    cfg, model = case["cfg"], case["model"]
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    state, tx = train.create_train_state(cfg, model)
    # gt_noise draws its noise from the generator
    _, metrics = train.make_train_step(cfg, model, tx)(
        state, case["batch"], torch.Generator().manual_seed(0))
    grads = {k: p.grad for k, p in model.named_parameters()}
    model.load_state_dict(sd)  # the forward test may run after this one
    assert set(case["losses"]) <= set(metrics)
    for k, v in case["losses"].items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    if case["grads"] is not None:
        assert_grads_match(grads, case["grads"])
