"""The MvP baseline (TRANSFORMER: multi_view_pose_transformer) in the port
against the JAX package, on a toy config (tools/make_golden.py's widths,
ResNet-18, dropout 0) with the same weights carried across by
port_state_dict_from_jax and the same synthetic batch:

  * one decoder layer (MvPDecoderLayer) for each of the 3 ProjAttn posembed
    modes x the 5 view fusions, on random features, the camera rays or 2D
    coordinates each package builds from the batch, at logits-class
    tolerance (rtol 1e-3, atol 2e-3);
  * the whole model with query_adaptation on (use_rayconv, cat_proj, the
    flagship's defaults) and off (use_2d_coordconv, attn_fuse_dot_prod):
    every layer's logits (rtol 1e-3 / atol 2e-3) and 3D (p99 < 2 mm, max
    < 6 mm);
  * with query_adaptation on: make_eval_step's (B, Q, J, 5) pred against
    JAX's make_eval_step, and one make_train_step's losses (rtol 1e-4) and
    gradients (1e-3 of a leaf's largest) against JAX's training forward,
    criterion and gradient, as JAX's make_train_step computes them for the
    MvP model (every layer matched on its own outputs, no 2D term);
  * build_model's dispatch on TRANSFORMER, the refusals of a view count
    the fusion was not built for, and of a window plan in the MvP steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvgformer_tpu.core import criterion as jcrit
from mvgformer_tpu.core import train as jtrain
from mvgformer_tpu.data.synthetic import make_batch as jax_make_batch
from mvgformer_tpu.geometry.cameras import calib_matrix as jcalib
from mvgformer_tpu.models import build_model as jax_build_model
from mvgformer_tpu.models import mvp_decoder as jmvp
from mvgformer_tpu.models import position_encoding as jpe
from mvgformer_tpu_torch.core import train
from mvgformer_tpu_torch.core.infer import make_eval_step
from mvgformer_tpu_torch.data.synthetic import batch_from_jax
from mvgformer_tpu_torch.models import build_model
from mvgformer_tpu_torch.models import mvp_decoder
from mvgformer_tpu_torch.models.mvgformer import MVGFormer
from mvgformer_tpu_torch.utils.jax_convert import (
    module_state_dict, port_state_dict_from_jax)
from torch_one_thread import one_torch_thread  # noqa: F401
from torch_parity import (assert_golden_classes,
                          assert_grads_match, toy_cfg)

MODES = ("use_rayconv", "use_2d_coordconv", "ablation_not_use_rayconv")
FUSIONS = ("mean", "cat_proj", "sum_proj", "attn_fuse_dot_prod",
           "attn_fuse_subtract")
THRESHOLD = 0.1


def mvp_cfg(**overrides):
    cfg = toy_cfg(overrides)
    cfg.TRANSFORMER = "multi_view_pose_transformer"
    return cfg


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --- one layer, every posembed mode x fusion -------------------------------

@pytest.fixture(scope="module")
def layer_inputs():
    cfg = mvp_cfg()
    jb = jax_make_batch(cfg, batch_size=1, seed=3, num_people=2)
    rng = np.random.RandomState(0)
    shapes = ((4, 6), (8, 12), (16, 24))
    V, Nq, C = cfg.DATASET.CAMERA_NUM, 2 * 15, cfg.DECODER.d_model
    return dict(
        cfg=cfg, jb=jb, shapes=shapes,
        src=[rng.randn(V, h, w, C).astype(np.float32) for h, w in shapes],
        tgt=rng.randn(1, Nq, C).astype(np.float32),
        pos=rng.randn(1, Nq, C).astype(np.float32),
        refs=rng.uniform(0.3, 0.7, (1, Nq, 3)).astype(np.float32))


def _jax_rays(mode, jb, shapes, image_size):
    """The ray / coordinate embeddings as JAX's MvPTransformer builds
    them."""
    vd = jb.view_data
    V = vd.affine.shape[1]
    if mode == "use_rayconv":
        Kc = jpe.crop_intrinsics(jcalib(vd.cameras), vd.affine)
        Tst = -jnp.matmul(vd.cameras.R, vd.cameras.T,
                          precision=jax.lax.Precision.HIGHEST)
        return jnp.concatenate([jnp.swapaxes(jpe.get_rays(
            tuple(image_size), h, w, Kc, vd.cameras.R, Tst), 0, 1).reshape(
            V, h * w, 3) for h, w in shapes], axis=1)
    if mode == "use_2d_coordconv":
        return jnp.concatenate([jnp.broadcast_to(
            jpe.get_2d_coords(h, w).reshape(1, h * w, 2), (V, h * w, 2))
            for h, w in shapes], axis=1)
    return None


@pytest.mark.parametrize("fuse", FUSIONS)
@pytest.mark.parametrize("mode", MODES)
def test_layer_matches_jax(layer_inputs, mode, fuse):
    li = layer_inputs
    cfg, jb, shapes = li["cfg"], li["jb"], li["shapes"]
    dec = cfg.DECODER
    kw = dict(d_model=dec.d_model, d_ffn=dec.dim_feedforward, dropout=0.0,
              n_levels=1, n_heads=dec.nhead, n_points=dec.dec_n_points,
              img_size=tuple(cfg.NETWORK.IMAGE_SIZE),
              space_size=tuple(cfg.MULTI_PERSON.SPACE_SIZE),
              space_center=tuple(cfg.MULTI_PERSON.SPACE_CENTER),
              fuse_view_feats=fuse, n_views=cfg.DATASET.CAMERA_NUM,
              posembed_mode=mode)
    jrays = _jax_rays(mode, jb, shapes, cfg.NETWORK.IMAGE_SIZE)
    jlayer = jmvp.MvPDecoderLayer(**kw)
    args = (jnp.asarray(li["tgt"]), jnp.asarray(li["pos"]),
            jnp.asarray(li["refs"]), [jnp.asarray(s) for s in li["src"]],
            shapes, jb.view_data)
    variables = jlayer.init(jax.random.PRNGKey(1), *args,
                            camera_ray_embeds=jrays)
    # the zero-initialized offset / weight kernels made random, so the
    # sampling reads the features where the query sends it
    params = jax.tree_util.tree_map(
        lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(2),
                                               x.shape),
        variables["params"])
    want = np.asarray(jlayer.apply({"params": params}, *args,
                                   camera_ray_embeds=jrays))

    layer = mvp_decoder.MvPDecoderLayer(**kw)
    layer.load_state_dict(module_state_dict(_to_np(params)))
    b = batch_from_jax(jb)
    rays = mvp_decoder.camera_embeddings(mode, b.view_data, shapes,
                                         cfg.NETWORK.IMAGE_SIZE)
    if jrays is None:
        assert rays is None
    else:
        # a unit ray is the difference of world points ~1e4 mm apart from
        # the origin: float32 cancellation leaves ~1e-3 in either package
        np.testing.assert_allclose(rays.numpy(), np.asarray(jrays),
                                   rtol=0, atol=2e-3)
    with torch.no_grad():
        got = layer(torch.from_numpy(li["tgt"]), torch.from_numpy(li["pos"]),
                    torch.from_numpy(li["refs"]),
                    [torch.from_numpy(s) for s in li["src"]], shapes,
                    b.view_data, camera_ray_embeds=rays).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-3)


# --- the whole model -------------------------------------------------------

MODEL_CASES = {
    "query_adaptation": {},
    "no_query_adaptation": {
        "DECODER.query_adaptation": False,
        "DECODER.projattn_posembed_mode": "use_2d_coordconv",
        "DECODER.fuse_view_feats": "attn_fuse_dot_prod"},
}


def _jax_run(cfg, jb, full):
    """JAX's variables and serving outputs; with `full` also the train
    step's losses and gradient (make_train_step's loss_fn for the MvP
    model) and make_eval_step's pred."""
    jm = jax_build_model(cfg)

    def loss_fn(params, batch_stats, batch):
        outs = jm.apply({"params": params, "batch_stats": batch_stats},
                        batch, train=True,
                        rngs={"dropout": jax.random.PRNGKey(1)})
        losses = jcrit.compute_losses(cfg, outs, batch, None,
                                      init_reference=None)
        return losses["total"], losses

    @jax.jit
    def run(key, batch):
        variables = jm.init(key, batch)
        outs = jm.apply(variables, batch)
        if not full:
            return variables, outs
        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"], variables["batch_stats"], batch)
        return variables, outs, losses, grads

    res = _to_np(run(jax.random.PRNGKey(0), jb))
    if not full:
        return res + (None, None, None)
    variables = res[0]
    pred = jtrain.make_eval_step(cfg, jm, THRESHOLD)(
        variables["params"], variables["batch_stats"], jb)
    return res + (np.asarray(pred),)


_CASES = {}


def _case(name):
    """The JAX run of MODEL_CASES[name] and the port's model on its
    weights, made once per module."""
    if name not in _CASES:
        cfg = mvp_cfg(**MODEL_CASES[name])
        full = name == "query_adaptation"
        jb = jax_make_batch(cfg, batch_size=1, seed=3, num_people=2)
        variables, outs, losses, grads, pred = _jax_run(cfg, jb, full)
        model = build_model(cfg, device="cpu")
        model.load_state_dict(port_state_dict_from_jax(variables, cfg))
        _CASES[name] = dict(
            cfg=cfg, batch=batch_from_jax(jb), outs=outs, losses=losses,
            pred=pred, model=model, grads=None if grads is None else
            port_state_dict_from_jax({"params": grads, "batch_stats":
                                      variables["batch_stats"]}, cfg))
    return _CASES[name]


@pytest.fixture(scope="module", params=list(MODEL_CASES))
def case(request):
    return _case(request.param)


@pytest.fixture(scope="module")
def full_case():
    """query_adaptation on, with JAX's eval pred, losses and gradients."""
    return _case("query_adaptation")


def test_forward_matches_jax(case):
    model = case["model"]
    with torch.no_grad():
        outs = model(case["batch"])
    assert len(outs) == len(case["outs"])
    for got, want in zip(outs, case["outs"]):
        assert set(got) == set(want) == {"pred_logits", "pred_poses"}
        assert_golden_classes({k: v.numpy() for k, v in got.items()}, want,
                              keys=("pred_logits", "pred_poses"))


def test_eval_pred_matches_jax(full_case):
    case = full_case
    pred = make_eval_step(case["cfg"], case["model"], THRESHOLD)(
        case["batch"]).numpy()
    want = case["pred"]
    Q, J = case["cfg"].DECODER.num_instance, 15
    assert pred.shape == want.shape == (1, Q, J, 5)
    err = np.abs(pred[..., :3] - want[..., :3])
    assert np.percentile(err, 99) < 2.0 and err.max() < 6.0
    np.testing.assert_allclose(pred[..., 4], want[..., 4], rtol=1e-3,
                               atol=2e-3)
    # no query filtering: every query's flag is 0 or -1 by its own score
    np.testing.assert_array_equal(pred[..., 3],
                                  (pred[..., 4] > THRESHOLD) - 1.0)


def test_train_step_matches_jax(full_case):
    case = full_case
    cfg, model = case["cfg"], case["model"]
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    state, tx = train.create_train_state(cfg, model)
    _, metrics = train.make_train_step(cfg, model, tx)(state, case["batch"])
    grads = {k: p.grad for k, p in model.named_parameters()}
    model.load_state_dict(sd)  # the forward test may run after this one
    want = case["losses"]
    assert not any("2d" in k for k in want)
    assert set(want) <= set(metrics)
    for k, v in want.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    # the frozen backbone: JAX's MvP computes its gradient and its
    # optimizer drops it; the port takes none
    assert_grads_match(grads, case["grads"])
    # the sampler's parameters learn: the corner sampler's gradient reaches
    # the offsets and the value projection
    for lin in ("sampling_offsets", "rayconv"):
        assert grads[f"decoder.layers.0.proj_attn.{lin}.weight"].abs().max(
        ) > 0, lin


# --- dispatch and refusals -------------------------------------------------

@pytest.mark.parametrize("transformer,cls", [
    ("dq_transformer", MVGFormer),
    ("multi_view_pose_transformer", mvp_decoder.MvPTransformer)])
def test_build_model_dispatch(transformer, cls):
    cfg = mvp_cfg(**{"DECODER.num_instance": 4})
    cfg.TRANSFORMER = transformer
    assert type(build_model(cfg, device="cpu")) is cls


def test_build_model_unknown_transformer_raises():
    cfg = mvp_cfg()
    # a name neither package builds (the port builds "voxelpose" too)
    cfg.TRANSFORMER = "pictorial_structures"
    with pytest.raises(ValueError, match="TRANSFORMER"):
        jax_build_model(cfg)
    with pytest.raises(ValueError, match="TRANSFORMER"):
        build_model(cfg, device="cpu")


def test_unknown_fusion_raises_in_both():
    cfg = mvp_cfg(**{"DECODER.fuse_view_feats": "max",
                     "DECODER.num_instance": 4})
    jb = jax_make_batch(cfg, batch_size=1, seed=0, num_people=1)
    with pytest.raises(NotImplementedError):
        jax_build_model(cfg).init(jax.random.PRNGKey(0), jb)
    with pytest.raises(ValueError, match="fuse_view_feats"):
        build_model(cfg, device="cpu")


def test_other_view_count_raises():
    """cat_proj and reference_feats are built for DATASET.CAMERA_NUM views:
    a batch with another count raises instead of broadcasting."""
    cfg = mvp_cfg(**{"DECODER.num_instance": 4})
    model = build_model(cfg, device="cpu")
    other = mvp_cfg(**{"DECODER.num_instance": 4, "DATASET.CAMERA_NUM": 2})
    batch = batch_from_jax(jax_make_batch(other, batch_size=1, seed=0,
                                          num_people=1))
    with torch.no_grad(), pytest.raises(ValueError, match="CAMERA_NUM"):
        model(batch)
    cfg.DECODER.query_adaptation = False
    model = build_model(cfg, device="cpu")
    with torch.no_grad(), pytest.raises(ValueError, match="CAMERA_NUM"):
        model(batch)


def test_window_plan_refused_by_the_mvp_steps():
    """The window plan is for the DQ model's layer 1: the MvP eval and
    eval-loss steps refuse one instead of dropping it."""
    cfg = mvp_cfg(**{"DECODER.num_instance": 4})
    model = build_model(cfg, device="cpu")
    plan = object()
    with pytest.raises(ValueError, match="window plan"):
        make_eval_step(cfg, model, THRESHOLD, window_plan=plan)
    with pytest.raises(ValueError, match="window plan"):
        train.make_eval_loss_step(cfg, model, THRESHOLD, window_plan=plan)
