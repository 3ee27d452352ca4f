"""View parallelism in the port (mvgformer_tpu_torch/parallel/) against its
own single process and against JAX's view-sharded program, on the toy DQ
config at 4 views (tests/torch_parity.py: tools/make_golden.py's widths,
ResNet-18, dropout 0, eigh DLT; DATASET.CAMERA_NUM 4).

The global batch is 2 frames from rigs of different image sizes (1920x1080
and 1280x720), so each frame's views have other crop centers. The ranks
are gloo CPU processes that `parallel.launch` starts on a (1 x 2) grid
(each rank 2 frames x 2 views), a (2 x 2) grid (1 frame x 2 views) and a
(2 x 1) data grid (1 frame x 4 views); the worker (tests/torch_vp_worker.py)
imports only the port.

  * Serving, against the port's 1-process run of the same cases on the
    whole batch (the option cases' weights from a seed): every layer's
    logits, 3D poses and the rank's views of the 2D poses at the golden
    classes (logits rtol 1e-3 / atol 2e-3, 2D atol 0.5 px, 3D p99 < 2 mm
    and max < 6 mm), the pred at rtol 1e-3 / atol 6 mm; the top-K indices
    of every compaction equal on every rank and to the 1-process run.
    Cases: dense (eigh), top-K 8 with point-top-2 (jacobi), the windowed
    layer 1 (impl 'xla'), 'query_adapt', 'st' and 'svd', the decoder
    variants (bayesian_update with init_self_attention and
    'attention_embed'; share_layer_weights with 'mean'), and the MvP
    baseline with 'cat_proj' and with 'attn_fuse_dot_prod'.
  * Serving against JAX: the dense case on every grid at the golden
    classes against JAX's unsharded serving outputs on the same weights;
    the (1 x 2) grid's pred against JAX's own view-sharded program
    (`make_mesh_2d(1, 2)` + `shard_batch(view_axis="view")` on 2 of the 8
    virtual CPU devices) at the bound JAX holds that program to against
    its unsharded run (rtol 1e-2 / atol 1.0 mm, tests/test_train.py).
  * The projection clamp under a data split: the (2 x 1) grid's dense
    pred at the golden classes against JAX's on the global batch. Before
    the clamp became a max over the data group, the 1280x720 frame's rank
    clamped at its own width and its pred was 1295 mm off. The same grid
    runs the MvP baseline ('cat_proj') against the 1-process run: its
    clip stays the rank's own largest width, which moves only projections
    that its bounds mask zeroes.
  * One training step (DQ with the gt match; MvP with 'cat_proj'): loss
    terms at rtol 1e-4 and every trainable gradient within 1e-3 of its
    leaf's largest against the 1-process step, the DQ step against JAX's
    loss gradient too; every rank's gradients and parameters after the
    Adam step equal bit for bit.
  * The port's collective structure, as tests/test_serving_hlo.py pins
    JAX's: one dense toy eval step at 2 and at 4 decoder layers on the
    (1 x 2) grid makes exactly 1 sum all-reduce and 1 all-gather on the
    view group per layer, plus 1 layer-independent all-gather. JAX's
    program makes 2 all-reduce + 3 all-gather per layer plus 1 all-gather:
    the port packs the 2D points and the confidence logits into one
    all-gather, takes the softmax over views after it, and gathers the
    projection matrices once per frame. bayesian_update adds 1 sum
    all-reduce per layer.
  * The collectives' autograd apart from the model: on the (1 x 2) grid
    the gradient of a loss through all_gather, the sum all_reduce and the
    max all_reduce, averaged over the ranks, equals the 1-process
    gradient, and each rank's input gradient is 2x its slice of it
    (parallel/collectives.py's derivation).
  * `predict_dataset` under the (1 x 2) and (2 x 2) grids: every rank
    gets every frame's pred, view rank 0's of each data row, against the
    1-process loop.
  * `shard_batch` places the views as JAX's does, and a view count the
    view world does not divide raises.
"""

import dataclasses
import pickle

import jax
import numpy as np
import pytest
import torch

import torch_vp_worker
from mvgformer_tpu.core.train import make_eval_step as jax_make_eval_step
from mvgformer_tpu.data.synthetic import make_batch as jax_make_batch
from mvgformer_tpu.models.mvgformer import MVGFormer as JMVGFormer
from mvgformer_tpu.parallel import make_mesh_2d
from mvgformer_tpu.parallel import shard_batch as jax_shard_batch
from mvgformer_tpu_torch.data.synthetic import batch_from_jax
from mvgformer_tpu_torch.models import build_model
from mvgformer_tpu_torch.parallel import DataParallel, launch, shard_batch
from torch_one_thread import one_torch_thread  # noqa: F401
from torch_parity import (assert_golden_classes, jax_batch, jax_run,
                          port_grads, port_model, toy_cfg)

VIEWS, GLOBAL_BATCH = 4, 2
GRIDS = {"1x2": (1, 2), "2x2": (2, 2), "2x1": (2, 1)}
LOSS_KEYS = ("total", "loss_ce", "loss_pose_perjoint",
             "loss_pose_perprojection_2d", "loss_init")
MVP = {"TRANSFORMER": "multi_view_pose_transformer",
       "DECODER.projattn_posembed_mode": "use_rayconv"}
# name -> (config overrides, kind, weights: 'jax' or a seed)
CASES = {
    "dense": ({}, "eval", "jax"),
    "dense_4layers": ({"DECODER.num_decoder_layers": 4}, "eval", 0),
    "topk_ptop": ({"DECODER.inference_topk_queries": 8,
                   "DECODER.triangulation_method": "jacobi",
                   "DECODER.dec_n_points": 4,
                   "DECODER.inference_point_topm": 2}, "eval", 0),
    "windowed": ({"DECODER.layer1_windowed_sampling": True}, "eval", "jax"),
    "query_adapt": ({"DECODER.init_ref_method": "query_adapt"}, "eval", 0),
    "st": ({"DECODER.triangulation_method": "st"}, "eval", 0),
    # the decoder variants: the bayesian blend's mean over views is one
    # more all-reduce per layer; the rest is replicated
    "variants": ({"DECODER.bayesian_update": True,
                  "DECODER.init_self_attention": True,
                  "DECODER.feature_update_method": "attention_embed"},
                 "eval", 0),
    "shared_mean": ({"DECODER.share_layer_weights": True,
                     "DECODER.feature_update_method": "mean"}, "eval", 0),
    "svd": ({"DECODER.triangulation_method": "linalg"}, "eval", 0),
    "mvp_cat_proj": ({**MVP, "DECODER.fuse_view_feats": "cat_proj"},
                     "eval", 0),
    "mvp_dot_prod": ({**MVP, "DECODER.fuse_view_feats":
                      "attn_fuse_dot_prod"}, "eval", 0),
    "train": ({}, "train", "jax"),
    "predict": ({}, "predict", "jax"),
    "mvp_train": ({**MVP, "DECODER.fuse_view_feats": "cat_proj"}, "train",
                  0),
}
ON_GRID = {"1x2": tuple(CASES),
           "2x2": ("dense", "topk_ptop", "train", "predict"),
           "2x1": ("dense", "mvp_cat_proj")}
EVAL = [(g, c) for g, cs in ON_GRID.items() for c in cs
        if CASES[c][1] == "eval"]
TRAIN = [(g, c) for g, cs in ON_GRID.items() for c in cs
         if CASES[c][1] == "train"]


def case_cfg(overrides):
    cfg = toy_cfg({"DATASET.CAMERA_NUM": VIEWS,
                   **{k: v for k, v in overrides.items() if "." in k}})
    if "TRANSFORMER" in overrides:
        cfg.TRANSFORMER = overrides["TRANSFORMER"]
    return cfg


def global_batch(cfg):
    """JAX's 2-frame batch: a 1920x1080 rig and a 1280x720 one."""
    a = jax_batch(cfg, seed=3)
    b = jax_make_batch(cfg, batch_size=1, seed=4, num_people=2,
                       image_size=(1280, 720))
    return jax.tree_util.tree_map(
        lambda x, y: np.concatenate([np.asarray(x), np.asarray(y)]), a, b)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cfg = case_cfg({})
    jb = global_batch(cfg)
    variables, jax_outs, jax_losses, jax_grads = jax_run(cfg, jb,
                                                         grads=True)
    batch = batch_from_jax(jb)
    cases = []
    for name, (overrides, kind, weights) in CASES.items():
        ccfg = case_cfg(overrides)
        model = (port_model(ccfg, variables) if weights == "jax" else
                 build_model(ccfg, generator=torch.Generator().manual_seed(
                     weights), device="cpu"))
        cases.append(dict(name=name, kind=kind,
                          sections=dataclasses.asdict(ccfg),
                          state_dict=model.state_dict(),
                          window=overrides.get(
                              "DECODER.layer1_windowed_sampling", False)))
    single = {c["name"]: torch_vp_worker.run_case(c, batch) for c in cases}

    # JAX's own view-sharded serving program on a (1 x 2) mesh
    jm = JMVGFormer(cfg=cfg)
    mesh = make_mesh_2d(1, 2)
    jax_sharded = np.asarray(jax_make_eval_step(cfg, jm, 0.1)(
        variables["params"], variables["batch_stats"],
        jax_shard_batch(jb, mesh, view_axis="view")))

    ranks, info = {}, {}
    for grid, (data, views) in GRIDS.items():
        out = tmp_path_factory.mktemp(f"vp{grid}")
        info[grid] = launch(torch_vp_worker.run_cases, data, "cpu",
                            [c for c in cases if c["name"] in ON_GRID[grid]],
                            batch, str(out), grid == "1x2", views=views)
        ranks[grid] = [pickle.load(open(out / f"rank{r}.pkl", "rb"))
                       for r in range(data * views)]
    return dict(cfg=cfg, variables=variables, jax_outs=jax_outs,
                jax_losses=jax_losses, jax_grads=jax_grads,
                jax_sharded=jax_sharded, single=single, ranks=ranks,
                info=info)


def shard_of(grid, rank):
    data, views = GRIDS[grid]
    dp = DataParallel(rank=rank, world=data * views, views=views)
    return dp.rows(GLOBAL_BATCH), dp.view_slice(VIEWS)


def layer_outputs(result, rows, views, layers):
    """Every layer's outputs of a result, cut to `rows` (and the 2D ones
    to `views`) where the result is the whole batch's."""
    out = []
    for lid in range(layers):
        o = {k.split("/")[1]: v for k, v in result.items()
             if k.startswith(f"layer{lid}/")}
        o = {k: v[rows] for k, v in o.items() if k != "escaped_mass"}
        for k in ("pred_poses_2d", "pred_poses_2d_proj"):
            if k in o and views is not None:
                o[k] = o[k][:, views]
        out.append(o)
    return out


def n_layers(result):
    return len({k.split("/")[0] for k in result if k.startswith("layer")})


def test_launch_reports_the_grid(run):
    for grid, (data, views) in GRIDS.items():
        assert run["info"][grid] == {"world": data * views, "views": views,
                                     "backend": "gloo"}


@pytest.mark.parametrize("grid, case", EVAL)
def test_eval_matches_one_process(run, grid, case):
    want = run["single"][case]
    for r, result in enumerate(run["ranks"][grid]):
        got = result[case]
        rows, views = shard_of(grid, r)
        keys = ("pred_logits", "pred_poses") + (
            ("pred_poses_2d",) if "layer0/pred_poses_2d" in want else ())
        L = n_layers(want)
        for g, w in zip(layer_outputs(got, slice(None), None, L),
                        layer_outputs(want, rows, views, L)):
            assert_golden_classes(g, w, keys=keys)
        np.testing.assert_allclose(got["pred"], want["pred"][rows],
                                   rtol=1e-3, atol=6.0)


@pytest.mark.parametrize("grid, case", EVAL)
def test_topk_indices_equal_on_every_rank(run, grid, case):
    want = run["single"][case]["topk"]
    if CASES[case][0].get("DECODER.inference_topk_queries"):
        assert want, "the top-K case made no compaction"
    for r, result in enumerate(run["ranks"][grid]):
        rows, _ = shard_of(grid, r)
        got = result[case]["topk"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w[rows])


@pytest.mark.parametrize("grid", ON_GRID)
def test_dense_eval_matches_jax(run, grid):
    """Every layer of the dense case at the golden classes against JAX's
    unsharded serving outputs; on the (2 x 1) grid this holds the clamp
    over the data group."""
    want = [{k: np.asarray(v) for k, v in o.items()}
            for o in run["jax_outs"]]
    for r, result in enumerate(run["ranks"][grid]):
        rows, views = shard_of(grid, r)
        got = layer_outputs(result["dense"], slice(None), None, len(want))
        for g, w in zip(got, want):
            w = {k: v[rows] for k, v in w.items()}
            w["pred_poses_2d"] = w["pred_poses_2d"][:, views]
            assert_golden_classes(g, w)


@pytest.mark.parametrize("grid", [g for g, cs in ON_GRID.items()
                                  if "predict" in cs])
def test_predict_dataset_matches_one_process(run, grid):
    """`predict_dataset` over 5 synthetic frames at batches of 2 (the last
    one padded): every rank returns every frame's pred, view rank 0's of
    each data row, at the golden 3D classes and the same flags."""
    want = run["single"]["predict"]["preds"]
    assert want.shape[0] == torch_vp_worker.PREDICT_FRAMES
    for result in run["ranks"][grid]:
        got = result["predict"]["preds"]
        assert got.shape == want.shape
        err = np.abs(got[..., :3] - want[..., :3])
        assert np.percentile(err, 99) < 2.0 and err.max() < 6.0
        np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=1e-3,
                                   atol=1e-5)


def test_eval_matches_jax_view_sharded_program(run):
    for result in run["ranks"]["1x2"]:
        np.testing.assert_allclose(result["dense"]["pred"],
                                   run["jax_sharded"], rtol=1e-2, atol=1.0)


def _grads(result):
    return {k[5:]: v for k, v in result.items() if k.startswith("grad/")}


def _assert_grads_close(got, want, min_checked=20):
    """Every trainable leaf within max|diff| <= 1e-3 * max|want| + 1e-6;
    the frozen backbone takes no gradient."""
    checked = 0
    for name, w in want.items():
        if name.startswith("backbone."):
            assert name not in got, name
            continue
        w = np.asarray(w)
        g = got.get(name, np.zeros_like(w))
        err = np.abs(g - w).max()
        assert err <= 1e-3 * np.abs(w).max() + 1e-6, (name, err)
        checked += 1
    assert checked >= min_checked, checked


@pytest.mark.parametrize("grid, case", TRAIN)
def test_train_step_matches_one_process(run, grid, case):
    want = run["single"][case]
    for result in run["ranks"][grid]:
        got = result[case]
        for key in LOSS_KEYS:
            if f"metric/{key}" in want:
                np.testing.assert_allclose(
                    float(got[f"metric/{key}"]), float(want[f"metric/{key}"]),
                    rtol=1e-4, atol=1e-6, err_msg=key)
        _assert_grads_close(_grads(got), _grads(want))


@pytest.mark.parametrize("grid", [g for g, c in TRAIN if c == "train"])
def test_train_step_matches_jax(run, grid):
    want = port_grads(run["cfg"], run["variables"], run["jax_grads"])
    for result in run["ranks"][grid]:
        got = result["train"]
        for key in LOSS_KEYS:
            np.testing.assert_allclose(float(got[f"metric/{key}"]),
                                       float(run["jax_losses"][key]),
                                       rtol=1e-4, atol=1e-6, err_msg=key)
        _assert_grads_close(_grads(got),
                            {k: v.numpy() for k, v in want.items()})


@pytest.mark.parametrize("grid, case", TRAIN)
def test_ranks_agree_bit_for_bit_after_a_step(run, grid, case):
    first, *rest = [result[case] for result in run["ranks"][grid]]
    for other in rest:
        assert set(other) - {"counts"} == set(first) - {"counts"}
        for key in first:
            if key.startswith(("grad/", "param/")):
                np.testing.assert_array_equal(first[key], other[key],
                                              err_msg=key)


def test_view_collectives_pinned(run):
    """Per decoder layer 1 sum all-reduce (the mean over views) and 1
    all-gather (the 2D points with the confidence logits); per frame 1
    all-gather (the projection matrices). JAX's view-sharded program:
    2 all-reduce + 3 all-gather per layer, plus 1 all-gather."""
    per_layer = {"view.all_reduce_sum": 1, "view.all_gather": 1}
    base = {"view.all_reduce_sum": 0, "view.all_gather": 1}
    for case, layers, bayes in (("dense", 2, 0), ("dense_4layers", 4, 0),
                                ("variants", 2, 1)):
        want = {k: base[k] + layers * per_layer[k] for k in per_layer}
        want["view.all_reduce_sum"] += layers * bayes
        for result in run["ranks"]["1x2"]:
            assert result[case]["counts"] == want, (case,
                                                    result[case]["counts"])
        assert run["single"][case]["counts"] == {}


def test_collectives_autograd_round_trip(run):
    """The mean over the ranks of the parameter's gradient through the
    view group's all_gather, sum all_reduce and max all_reduce is the
    1-process gradient; each rank's input gradient is n times its slice
    of the 1-process one."""
    x, theta, w = torch_vp_worker.round_trip_inputs()
    xs = x.clone().requires_grad_(True)
    th = theta.clone().requires_grad_(True)
    y = torch.tanh(xs * th)
    loss = (y @ w).sum() + ((y * y).sum(dim=0) * th).sum() + \
        y.max(dim=0).values.sum()
    loss.backward()
    rows = run["ranks"]["1x2"][0]["round_trip"]
    n = len(rows)
    for r, (value, g_theta, g_x) in enumerate(rows):
        assert value == pytest.approx(float(loss.detach()), rel=1e-6)
        part = slice(r * x.shape[0] // n, (r + 1) * x.shape[0] // n)
        np.testing.assert_allclose(g_x, n * xs.grad[part].numpy(),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.mean([r[1] for r in rows], axis=0),
                               th.grad.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rank", range(2))
def test_shard_batch_views_match_jax_placement(rank):
    cfg = case_cfg({})
    jb = global_batch(cfg)
    mesh = make_mesh_2d(1, 2)
    placed = jax_shard_batch(jb, mesh, view_axis="view")
    device = mesh.devices.reshape(-1)[rank]
    mine = shard_batch(batch_from_jax(jb), DataParallel(rank=rank, world=2,
                                                        views=2))
    for got, leaf in ((mine.views, placed.views),
                      (mine.view_data.affine, placed.view_data.affine),
                      (mine.view_data.cameras.R, placed.view_data.cameras.R),
                      (mine.targets.joints_3d, placed.targets.joints_3d)):
        shard = next(s for s in leaf.addressable_shards
                     if s.device == device)
        np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))


def test_uneven_view_split_raises():
    cfg = case_cfg({"DATASET.CAMERA_NUM": 3})
    batch = batch_from_jax(jax_batch(cfg))
    with pytest.raises(ValueError, match="do not split"):
        shard_batch(batch, DataParallel(rank=0, world=2, views=2))
    with pytest.raises(ValueError, match="does not form a grid"):
        DataParallel(rank=0, world=3, views=2)
