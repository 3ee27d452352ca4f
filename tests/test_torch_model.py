"""The port's model slice against the JAX package on the same inputs and the
same weights, carried across by `port_state_dict_from_jax`:

  * the PoseResNet backbone;
  * the whole forward on the three golden toy configs of
    tools/make_golden.py (dense_linalg, topk_jacobi, topk_jacobi_ptop4),
    at the golden tolerance classes of tests/test_golden.py, also with the
    DLT's dispatch deciding as on the card (ops/dlt_jacobi.py);
  * make_eval_step's pred;
  * the converter round trip through the JAX package's own converter;
  * the synthetic batch, made in numpy from the same seed.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import make_golden  # noqa: E402

from mvgformer_tpu.core.train import make_eval_step as jax_make_eval_step  # noqa: E402
from mvgformer_tpu.data.synthetic import make_batch as jax_make_batch  # noqa: E402
from mvgformer_tpu.models.mvgformer import MVGFormer as JMVGFormer  # noqa: E402
from mvgformer_tpu.utils.torch_convert import convert_mvgformer_state_dict  # noqa: E402
from mvgformer_tpu_torch.core.infer import make_eval_step  # noqa: E402
from mvgformer_tpu_torch.data.synthetic import batch_from_jax, make_batch  # noqa: E402
from mvgformer_tpu_torch.models.mvgformer import MVGFormer  # noqa: E402
from mvgformer_tpu_torch.utils.jax_convert import port_state_dict_from_jax  # noqa: E402

THRESHOLD = 0.1
CONFIGS = list(make_golden.CONFIGS)


@functools.lru_cache(maxsize=None)
def _run(name):
    """JAX init + forward + eval pred + backbone features in one jitted
    program, and the port loaded with the same weights."""
    cfg = make_golden.toy_cfg(**make_golden.CONFIGS[name])
    jm = JMVGFormer(cfg=cfg)
    batch = jax_make_batch(cfg, batch_size=2, seed=7, num_people=2)
    V = cfg.DATASET.CAMERA_NUM
    imgs = batch.views.swapaxes(0, 1).reshape((V * 2,) + batch.views.shape[2:])

    @jax.jit
    def run(key, batch, imgs):
        variables = jm.init(key, batch)
        outs = jm.apply(variables, batch, threshold=THRESHOLD)
        pred = jax_make_eval_step(cfg, jm, THRESHOLD)(
            variables["params"], variables["batch_stats"], batch)
        feats = jm.apply(variables, imgs,
                         method=lambda m, x: m.backbone(x))
        return variables, outs, pred, feats

    variables, outs, pred, feats = jax.tree_util.tree_map(
        np.asarray, run(jax.random.PRNGKey(0), batch, imgs))
    model = MVGFormer(cfg, device="cpu")
    model.load_state_dict(port_state_dict_from_jax(variables, cfg))
    model.eval()
    return dict(cfg=cfg, batch=batch, imgs=np.array(imgs),
                variables=variables, outs=outs, pred=pred, feats=feats,
                model=model)


def _assert_golden_classes(got, want):
    """The tolerance classes of tests/test_golden.py."""
    np.testing.assert_allclose(got["pred_logits"], want["pred_logits"],
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(got["pred_poses_2d"], want["pred_poses_2d"],
                               rtol=1e-3, atol=0.5)
    err = np.abs(got["pred_poses"] - want["pred_poses"])
    assert np.percentile(err, 99) < 2.0, np.percentile(err, 99)
    assert err.max() < 6.0, err.max()


@pytest.mark.parametrize("name", CONFIGS)
def test_slice_matches_jax(name):
    r = _run(name)
    with torch.no_grad():
        outs = r["model"](batch_from_jax(r["batch"]), threshold=THRESHOLD)
    assert len(outs) == len(r["outs"])
    for got, want in zip(outs, r["outs"]):
        _assert_golden_classes({k: v.numpy() for k, v in got.items()}, want)


@pytest.mark.parametrize("name", CONFIGS)
def test_slice_matches_jax_through_the_dlt_dispatch(name, monkeypatch):
    """The golden forward with the DLT rule deciding as for CUDA tensors:
    the Jacobi configs take the fused branch (on the CPU, the plain chain
    as `fused_dlt` runs it), the others the plain chain; the outputs are
    the undispatched forward's bits and within the golden classes of JAX's.
    Nothing launches and no call counts as plain."""
    from mvgformer_tpu_torch.ops import dlt_jacobi

    r = _run(name)
    batch = batch_from_jax(r["batch"])
    with torch.no_grad():
        want = r["model"](batch, threshold=THRESHOLD)
    rule = dlt_jacobi.fused_path
    monkeypatch.setattr(dlt_jacobi, "fused_path", lambda device, *args:
                        rule(torch.device("cuda"), *args))
    counts = (dlt_jacobi.fused_dlt.launches, dlt_jacobi.fused_dlt.plain_calls)
    with torch.no_grad():
        outs = r["model"](batch, threshold=THRESHOLD)
    assert (dlt_jacobi.fused_dlt.launches,
            dlt_jacobi.fused_dlt.plain_calls) == counts
    for got, ref, jax_out in zip(outs, want, r["outs"]):
        for key in got:
            assert torch.equal(got[key], ref[key]), key
        _assert_golden_classes({k: v.numpy() for k, v in got.items()},
                               jax_out)


def test_backbone_matches_jax():
    r = _run("topk_jacobi")
    with torch.no_grad():
        feats = r["model"].backbone(torch.from_numpy(r["imgs"]))
    assert len(feats) == len(r["feats"])
    for got, want in zip(feats, r["feats"]):
        assert got.shape == want.shape
        # float32 convolutions summed in another order, through 50 layers
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * scale)


@pytest.mark.parametrize("name", ["dense_linalg", "topk_jacobi_ptop4"])
def test_eval_step_pred_matches_jax(name):
    r = _run(name)
    pred = make_eval_step(r["cfg"], r["model"], THRESHOLD)(
        batch_from_jax(r["batch"])).numpy()
    want = r["pred"]
    assert pred.shape == want.shape == (2, 16, 15, 5)
    err = np.abs(pred[..., :3] - want[..., :3])
    assert np.percentile(err, 99) < 2.0 and err.max() < 6.0
    np.testing.assert_allclose(pred[..., 4], want[..., 4], rtol=1e-3,
                               atol=1e-4)
    # the flag channel is exact wherever the score is not at the threshold
    clear = np.abs(want[..., 4] - THRESHOLD) > 1e-4
    np.testing.assert_array_equal(pred[..., 3][clear], want[..., 3][clear])


@pytest.mark.parametrize("name", ["dense_linalg", "topk_jacobi_ptop4"])
def test_converter_round_trip(name):
    """JAX variables -> port state_dict -> the JAX package's converter gives
    back the same arrays, and the port model holds exactly those keys."""
    r = _run(name)
    sd = port_state_dict_from_jax(r["variables"], r["cfg"])
    assert set(sd) == set(r["model"].state_dict())
    back = convert_mvgformer_state_dict(sd, r["cfg"])
    want = jax.tree_util.tree_flatten_with_path(r["variables"])[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_make_batch_matches_jax():
    cfg = make_golden.toy_cfg(**make_golden.CONFIGS["topk_jacobi"])
    want = jax_make_batch(cfg, batch_size=2, seed=11, num_people=3)
    got = make_batch(cfg, batch_size=2, seed=11, num_people=3,
                     device="cpu")
    ref = batch_from_jax(want)
    np.testing.assert_array_equal(got.views.numpy(), ref.views.numpy())
    for f in ("R", "T", "f", "c", "k", "p"):
        np.testing.assert_array_equal(
            getattr(got.view_data.cameras, f).numpy(),
            getattr(ref.view_data.cameras, f).numpy())
    for f in ("centers", "scales", "joints_vis_2d"):
        np.testing.assert_array_equal(getattr(got.view_data, f).numpy(),
                                      getattr(ref.view_data, f).numpy())
    for f in ("affine", "inv_affine"):
        np.testing.assert_allclose(getattr(got.view_data, f).numpy(),
                                   getattr(ref.view_data, f).numpy(),
                                   rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got.targets.joints_3d.numpy(),
                                  ref.targets.joints_3d.numpy())
