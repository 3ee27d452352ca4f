"""The port's debug dumps against the JAX package's, on the toy DQ config
(tests/torch_parity.py's, with top-8 queries after layer 1 and point-top-1
of 2 points, so the taps see both compactions), JAX's weights carried
across:

  * the taps (`MVGFormer.forward(..., return_intermediates=True)`):
    the same tree as JAX's sown intermediates (decoder/layer_{l}/
    proj_attn/sampling_locations and sampling_weights, one entry each,
    view-major (V*B, Lq, H, L, P[, 2])), the locations at the golden 2D
    class (0.5 px in each level's own pixels) and the weights at the
    logits class (rtol 1e-3, atol 2e-3); nothing kept without the flag,
    refused in training;
  * `utils.visualization.visualize_frame` writes the file names JAX's
    writes for the same batch and outputs; the epipolar pickle holds
    JAX's arrays (images and visibility equal, 2D joints within 1e-3 px);
  * the validate CLI with DEBUG.VISUALIZATION_JUMP_NUM=0 and DEBUG.DEBUG
    on configs/synthetic_smoke.yaml (1 frame, --device cpu) writes the
    files that JAX's run/validate.py writes there: its debug loop
    (`visualize_frame` and the three DEBUG.DEBUG savers per frame) run
    here with JAX's modules on JAX's outputs of the same structure (2
    layers, 3 views; JAX's CLI itself compiles for ~2 min on the CPU);
  * without matplotlib the plots raise ImportError.
"""

import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

from mvgformer_tpu.data.synthetic import make_batch as jax_make_batch
from mvgformer_tpu.models.mvgformer import MVGFormer as JMVGFormer
from mvgformer_tpu.utils import visualization as jvis
from mvgformer_tpu_torch.core.infer import make_eval_step
from mvgformer_tpu_torch.data.synthetic import batch_from_jax
from mvgformer_tpu_torch.run import validate as validate_cli
from mvgformer_tpu_torch.run.validate import to_numpy
from mvgformer_tpu_torch.utils import visualization as pvis
from torch_one_thread import one_torch_thread  # noqa: F401
from torch_parity import THRESHOLD, port_model, toy_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "synthetic_smoke.yaml")
OVERRIDES = {"DECODER.inference_topk_queries": 8,
             "DECODER.inference_point_topm": 1}
TAPS = [(layer, key) for layer in ("layer_0", "layer_1")
        for key in ("sampling_locations", "sampling_weights")]


@pytest.fixture(scope="module")
def run():
    cfg = toy_cfg(OVERRIDES)
    jm = JMVGFormer(cfg=cfg)
    jb = jax_make_batch(cfg, batch_size=1, seed=3, num_people=2, render=True)
    rngs = {"init_ref": jax.random.PRNGKey(2)}

    @jax.jit
    def debug_run(key, batch):
        variables = jm.init({"params": key, **rngs}, batch)
        variables = {k: variables[k] for k in ("params", "batch_stats")}
        outs, st = jm.apply(variables, batch, threshold=THRESHOLD,
                            rngs=rngs, mutable=["intermediates"])
        return variables, outs, st["intermediates"]

    variables, outs, inter = jax.tree_util.tree_map(
        np.asarray, debug_run(jax.random.PRNGKey(0), jb))
    model = port_model(cfg, variables)
    batch = batch_from_jax(jb)
    with torch.no_grad():
        pouts, pinter = model(batch, threshold=THRESHOLD,
                              return_intermediates=True)
    pred = make_eval_step(cfg, model, THRESHOLD)(batch)[0].numpy()
    return dict(cfg=cfg, jb=jb, batch=batch, model=model, outs=outs,
                inter=inter, pouts=to_numpy(pouts),
                pinter=to_numpy(pinter), pred=pred)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(np.shape(x) for x in tree)


def test_taps_tree_matches_jax(run):
    assert _shapes(run["pinter"]) == _shapes(run["inter"])
    # layer 2 runs the top-8 queries at point-top-1
    V, J = 3, 15
    assert _shapes(run["pinter"])["decoder"]["layer_1"]["proj_attn"][
        "sampling_locations"] == ((V, 8 * J, 4, 3, 1, 2),)


@pytest.mark.parametrize("layer, key", TAPS)
def test_taps_match_jax(run, layer, key):
    got = run["pinter"]["decoder"][layer]["proj_attn"][key][0]
    want = run["inter"]["decoder"][layer]["proj_attn"][key][0]
    if key == "sampling_weights":
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-3)
        return
    # in each level's own pixels (w, h), the golden 2D class
    from mvgformer_tpu_torch.models.mvgformer import feature_spatial_shapes

    wh = np.array([[w, h] for h, w in feature_spatial_shapes(run["cfg"])],
                  dtype=np.float32)
    err = np.abs(got - want) * wh[None, None, None, :, None, :]
    assert err.max() < 0.5, err.max()


def test_no_taps_without_the_flag_and_none_in_training(run):
    model, batch = run["model"], run["batch"]
    with torch.no_grad():
        outs = model(batch, threshold=THRESHOLD)
    assert isinstance(outs, list) and len(outs) == len(run["pouts"])
    with pytest.raises(ValueError, match="serving forward"):
        model(batch, train=True, return_intermediates=True)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def _jax_cli_debug_files(run, out_dir, frames):
    """The files run/validate.py's debug branch writes for `frames` under
    VISUALIZATION_JUMP_NUM 0 and DEBUG.DEBUG, with JAX's modules."""
    vis_dir = os.path.join(out_dir, "vis")
    preds = run["pred"][None]
    for frame_idx in frames:
        jvis.visualize_frame(vis_dir, frame_idx, run["jb"], run["pred"],
                             layer_outputs=run["outs"],
                             intermediates=run["inter"], batch_index=0)
        prefix = os.path.join(vis_dir, f"frame{frame_idx}")
        jvis.save_debug_3d_images(run["cfg"], run["jb"], preds, prefix)
        jvis.save_debug_3d_cubes(run["cfg"], run["jb"],
                                 preds[:, :, run["cfg"].DATASET.ROOTIDX, :4],
                                 prefix)
        jvis.save_debug_epipolar_dump(run["jb"], prefix, batch_index=0)
    return _files(vis_dir)


@pytest.fixture(scope="module")
def jax_files(run, tmp_path_factory):
    """JAX's debug files of frame 0 (one run of the plots, shared)."""
    return _jax_cli_debug_files(run, str(tmp_path_factory.mktemp("j")),
                                frames=(0,))


def test_visualize_frame_writes_jax_file_names(run, jax_files, tmp_path):
    pvis.visualize_frame(str(tmp_path), 0, run["batch"], run["pred"],
                         layer_outputs=run["pouts"],
                         intermediates=run["pinter"])
    got = _files(tmp_path)
    assert got == [f for f in jax_files if os.sep not in f]
    # 3D, a view grid per layer, attention points per layer and view
    assert len(got) == 1 + 2 + 2 * 3, got


def test_epipolar_pickle_matches_jax(run, tmp_path):
    jfile = jvis.save_debug_epipolar_dump(run["jb"],
                                          str(tmp_path / "j" / "f0"))
    pfile = pvis.save_debug_epipolar_dump(run["batch"],
                                          str(tmp_path / "p" / "f0"))
    assert os.path.basename(jfile) == os.path.basename(pfile)
    with open(jfile, "rb") as f:
        want = pickle.load(f)
    with open(pfile, "rb") as f:
        got = pickle.load(f)
    assert sorted(got) == sorted(want)
    for key in want:
        if key.endswith("_joints_2d"):
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=1e-3, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_validate_cli_writes_jax_debug_files(jax_files, tmp_path):
    res = validate_cli.main([
        "--cfg", SMOKE, "--device", "cpu", f"OUTPUT_DIR={tmp_path}",
        "DATASET.MAX_DATA_NUM=1", "DEBUG.VISUALIZATION_JUMP_NUM=0",
        "DEBUG.DEBUG=true"])
    assert res[0.1]["loop"]["frames"] == 1
    got = _files(tmp_path / "synthetic" / "synthetic_smoke" / "vis")
    assert got == jax_files
    assert len(got) == 1 + 2 + 2 * 3 + 3, got


def test_plots_raise_without_matplotlib(run, tmp_path, monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        pvis.visualize_frame(str(tmp_path), 0, run["batch"], run["pred"])
    # the epipolar pickle needs no plotting library
    assert os.path.isfile(pvis.save_debug_epipolar_dump(
        run["batch"], str(tmp_path / "f0")))
