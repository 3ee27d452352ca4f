"""The port's benches (mvgformer_tpu_torch/bench.py and bench_detail.py)
against the root bench.py and bench_detail.py, on the CPU:

  (a) bench_detail's ROWS are the root script's 26 rows, the same names,
      kinds and arguments in the same order (its run_config and
      run_train_config replaced by recorders, its main called);
  (b) every row's config and bench's own equal the config the root scripts
      build, field by field (the JAX model replaced by a stub that records
      the config and raises);
  (c) the chained serving loop (`bench.chained`, 3 frames) at the dry run's
      tiny widths in float32, on JAX's weights carried across by
      port_state_dict_from_jax, against the root bench_detail's scan body
      (bench_detail.py:49-56) over 3 iterations with the last pred kept:
      the last pred at the golden classes, eps exactly 0;
  (d) 3 training steps chained through the state
      (`bench_detail.chained_steps`) against the root bench_detail's
      chained make_train_step (the scan of bench_detail.py:99-107), dropout
      0: each step's total at rtol 1e-4;
  (e) both mains with --device cpu --toy print their lines and keys;
  (f) without --device cpu each main raises before any work, as this
      machine has no card;
  (g) a row that raises prints its error line, the next row runs, and main
      exits 1.

JAX's Jacobi solve runs op by op on the host, as in
tests/test_torch_train_step.py (`_jacobi_hosted`), so that no XLA compile
of its unrolled gradient is needed; one module fixture makes JAX's train
state once and serves (c) and (d) from it. In (d) both sides' KNN match
costs are rounded to 1e-3, as tests/test_torch_tools_ap_train.py rounds
them: on this 16-query grid the L1 costs of frame 0 hold exact ties that
each framework's float32 sum breaks its own way (2 of the 16 queries
differ without the rounding), so a tie is a tie in both and both take the
lower index; the match itself is held to JAX's in
tests/test_torch_train_matcher.py.
"""

import copy
import dataclasses
import importlib.util
import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvgformer_tpu import config as jconfig
from mvgformer_tpu.core import train as jtrain
from mvgformer_tpu.data.synthetic import make_batch as jax_make_batch
from mvgformer_tpu.geometry import triangulate as jtri
from mvgformer_tpu.models import matcher as jmatcher
from mvgformer_tpu.models import mvgformer as jmvgformer
from mvgformer_tpu_torch import bench, bench_detail
from mvgformer_tpu_torch.core import criterion as pcriterion
from mvgformer_tpu_torch.core.infer import make_eval_step
from mvgformer_tpu_torch.core.train import create_train_state, make_train_step
from mvgformer_tpu_torch.data.synthetic import batch_from_jax
from mvgformer_tpu_torch.models.mvgformer import MVGFormer
from mvgformer_tpu_torch.utils.jax_convert import port_state_dict_from_jax
from test_torch_config import PORT_ONLY
from test_torch_train_step import _jacobi_hosted
from torch_one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3


def _root_script(name):
    """The root script `name`.py as a module of its own name."""
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", os.path.join(REPO, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jbench = _root_script("bench")
jbench_detail = _root_script("bench_detail")


def _tree(cfg):
    """A config as {dotted key: (type name, value)}, without the port's
    own keys (`PORT_ONLY`), which the JAX package's config does not
    have."""
    flat = {}

    def walk(d, path):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, f"{path}{k}.")
            elif path + k not in PORT_ONLY:
                flat[path + k] = (type(v).__name__, v)
    walk(dataclasses.asdict(cfg), "")
    return flat


def _jax_cfg(cfg):
    """The JAX package's config with every field of the port's `cfg`."""
    jcfg = jconfig.load_config()
    for name, value in dataclasses.asdict(cfg).items():
        if isinstance(value, dict):
            for key, v in value.items():
                if f"{name}.{key}" not in PORT_ONLY:
                    setattr(getattr(jcfg, name), key, copy.deepcopy(v))
        else:
            setattr(jcfg, name, value)
    assert _tree(jcfg) == _tree(cfg)
    return jcfg


# (a), (b) ------------------------------------------------------------------

def test_rows_are_the_root_scripts_rows(monkeypatch):
    calls = []
    monkeypatch.setattr(jbench_detail, "run_config", lambda name, **kw:
                        calls.append((name, bench_detail.SERVE, kw)))
    monkeypatch.setattr(jbench_detail, "run_train_config", lambda name, **kw:
                        calls.append((name, bench_detail.TRAIN, kw)))
    jbench_detail.main()
    assert len(calls) == 26
    assert sum(kind == bench_detail.TRAIN for _, kind, _ in calls) == 6
    assert list(bench_detail.ROWS) == calls


class _Captured(Exception):
    pass


def _port_row_cfg(kind, kwargs):
    make = (bench_detail.serve_cfg if kind == bench_detail.SERVE
            else bench_detail.train_cfg)
    params = inspect.signature(make).parameters
    return make(**{k: v for k, v in kwargs.items() if k in params})


def test_row_configs_equal_the_root_scripts(monkeypatch, capsys):
    captured = []

    def stub(cfg=None, **_):
        captured.append(copy.deepcopy(cfg))
        raise _Captured

    monkeypatch.setattr(jmvgformer, "MVGFormer", stub)
    jbench_detail.main()
    errors = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [e["config"] for e in errors] == [r[0] for r in bench_detail.ROWS]
    with pytest.raises(_Captured):
        jbench.main()
    assert len(captured) == 27
    for (name, kind, kwargs), want in zip(bench_detail.ROWS, captured):
        assert _tree(_port_row_cfg(kind, kwargs)) == _tree(want), name
    assert _tree(bench.bench_cfg()) == _tree(captured[-1])


# (c), (d) ------------------------------------------------------------------

def _rounded(cost_fn, round_fn):
    """The match cost rounded to 1e-3 (the module docstring)."""
    def cost(*args, **kwargs):
        return round_fn(cost_fn(*args, **kwargs) * 1e3) / 1e3
    return cost


def _float32(cfg):
    cfg.PARALLEL.COMPUTE_DTYPE = "float32"
    cfg.DECODER.dropout = 0.0
    return cfg


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's initial variables, the last pred and eps of the root
    bench_detail's chained serving scan (its body, with the last frame's
    bench.py pred carried out), and each total of its chained training
    scan; at the dry run's widths in float32, dropout 0."""
    serve_cfg = _float32(bench.bench_cfg(toy=True))
    train_cfg = _float32(bench_detail.train_cfg("jacobi", toy=True))
    jserve, jtrain_cfg = _jax_cfg(serve_cfg), _jax_cfg(train_cfg)
    jb = jax_make_batch(jtrain_cfg, batch_size=1, seed=0, num_people=3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtri, "jacobi4_smallest",
                   lambda G, sweeps=6: _jacobi_hosted(G))
        mp.setattr(jmatcher, "pose_l1_cost",
                   _rounded(jmatcher.pose_l1_cost, jnp.round))
        jm = jmvgformer.MVGFormer(cfg=jtrain_cfg)
        state, tx = jtrain.create_train_state(jtrain_cfg, jm, jb,
                                              jax.random.PRNGKey(0))
        step_fn = jtrain.make_train_step(jtrain_cfg, jm, tx, donate=False)
        served = jmvgformer.MVGFormer(cfg=jserve)
        threshold = bench.THRESHOLD

        @jax.jit
        def chained_serve(params, batch_stats, batch):
            def body(carry, _):
                eps, _ = carry
                b = dataclasses.replace(batch, views=batch.views + eps)
                outs = served.apply({"params": params,
                                     "batch_stats": batch_stats},
                                    b, threshold=threshold)
                out = outs[-1]
                B, Q = out["pred_logits"].shape[:2]
                poses = out["pred_poses"].reshape(B, Q, -1, 3)
                score = jax.nn.sigmoid(out["pred_logits"][:, :, 1:2])
                score = jnp.broadcast_to(score[:, :, None],
                                         poses.shape[:3] + (1,))
                flag = (score > threshold).astype(poses.dtype) - 1.0
                pred = jnp.concatenate([poses, flag, score], axis=-1)
                eps = (jnp.sum(out["pred_poses"]).astype(jnp.float32)
                       * 0.0)
                return (eps, pred), None

            B = batch.views.shape[0]
            Q = jserve.DECODER.num_instance
            J = jserve.DECODER.num_keypoints
            (eps, pred), _ = jax.lax.scan(
                body, (jnp.float32(0.0), jnp.zeros((B, Q, J, 5))), None,
                length=STEPS)
            return eps, pred

        @jax.jit
        def chained_train(state, batch, rng):
            def body(carry, _):
                st, r = carry
                r, sub = jax.random.split(r)
                st, metrics = step_fn(st, batch, sub)
                return (st, r), metrics["total"]

            _, totals = jax.lax.scan(body, (state, rng), None, length=STEPS)
            return totals

        eps, pred = chained_serve(state.params, state.batch_stats, jb)
        totals = chained_train(state, jb, jax.random.PRNGKey(1))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"serve_cfg": serve_cfg, "train_cfg": train_cfg,
            "batch": batch_from_jax(jb),
            "variables": {"params": to_np(state.params),
                          "batch_stats": to_np(state.batch_stats)},
            "eps": float(eps), "pred": np.asarray(pred),
            "totals": np.asarray(totals)}


def _port_model(cfg, variables):
    model = MVGFormer(cfg, device="cpu")
    model.load_state_dict(port_state_dict_from_jax(variables, cfg))
    return model


def test_chained_serving_matches_jax(jax_runs):
    cfg = jax_runs["serve_cfg"]
    step = make_eval_step(cfg, _port_model(cfg, jax_runs["variables"]),
                          bench.THRESHOLD)
    pred, eps, finite = bench.chained(step, jax_runs["batch"], STEPS)
    assert float(eps) == 0.0 and jax_runs["eps"] == 0.0
    assert bool(finite)
    got, want = pred.numpy(), jax_runs["pred"]
    assert got.shape == want.shape == (1, 16, 15, 5)
    err = np.abs(got[..., :3] - want[..., :3])
    assert np.percentile(err, 99) < 2.0 and err.max() < 6.0, err.max()
    # the score is the sigmoid of the logits: their class
    np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=1e-3,
                               atol=2e-3)
    clear = np.abs(want[..., 4] - bench.THRESHOLD) > 2e-3
    np.testing.assert_array_equal(got[..., 3][clear], want[..., 3][clear])


def test_chained_training_matches_jax(jax_runs, monkeypatch):
    monkeypatch.setattr(pcriterion, "pose_l1_cost",
                        _rounded(pcriterion.pose_l1_cost, torch.round))
    cfg = jax_runs["train_cfg"]
    model = _port_model(cfg, jax_runs["variables"])
    state, tx = create_train_state(cfg, model)
    step = make_train_step(cfg, model, tx)
    state, totals = bench_detail.chained_steps(
        step, state, jax_runs["batch"], torch.Generator().manual_seed(1),
        STEPS)
    assert state.step == STEPS
    np.testing.assert_allclose(totals.numpy(), jax_runs["totals"],
                               rtol=1e-4)


# (e), (f), (g) -------------------------------------------------------------

def _lines(capsys):
    return [json.loads(s) for s in capsys.readouterr().out.splitlines()]


def test_bench_main_prints_its_lines(capsys):
    result = bench.main(["--device", "cpu", "--toy"])
    lines = _lines(capsys)
    assert lines[-1] == result
    assert [ln.get("phase") for ln in lines[:-1]] == [
        "build", "check", "frames", "syncs", "profile", "memory"]
    assert set(result) == {"metric", "value", "unit", "vs_baseline",
                           "repeats", "frames_per_repeat", "min", "max",
                           "device", "correct"}
    assert result["metric"] == "panoptic_5view_inference_fps_per_chip"
    assert result["correct"] is True and result["device"] == "cpu"
    assert set(lines[0]["host"]) == {"cpu", "cores", "load_avg", "us_per_op"}
    # the CPU measures no card
    assert result["value"] is None and lines[3]["syncs_per_frame"] is None
    assert lines[4]["device_idle_share"] is None


def test_idle_share_is_of_a_timed_frame(monkeypatch):
    window = {"device_busy_s": 0.09, "device_idle_share": 0.8}
    monkeypatch.setattr(bench, "profile_window",
                        lambda fn, runs, per_launch: dict(window))
    run = {"seconds": [2.0, 1.6, 1.8]}
    out = bench.profile_frames(None, None, run, 20, torch.device("cuda"))
    # 30 ms busy a frame in a timed frame of 90 ms
    assert out["device_busy_ms_per_frame"] == pytest.approx(30.0)
    assert out["timed_ms_per_frame"] == pytest.approx(90.0)
    assert out["device_idle_share"] == pytest.approx(2 / 3)
    assert out["profile"]["window_idle_share"] == 0.8
    assert "device_idle_share" not in out["profile"]


def test_bench_detail_main_prints_its_rows(capsys):
    rows = bench_detail.main(["--device", "cpu", "--toy",
                              "topk64_jacobi_b1", "train_gtmatch_jacobi_b1"])
    lines = _lines(capsys)
    assert lines[0]["phase"] == "build" and lines[1:] == rows
    assert [r["config"] for r in rows] == [
        "train_gtmatch_jacobi_b1", "train_gtmatch_jacobi_b1_chunk8",
        "topk64_jacobi_b1"]
    common = {"config", "min", "max", "repeats", "batch", "peak_gib",
              "device"}
    assert set(rows[-1]) == common | {
        "fps_per_chip", "frames_per_repeat", "syncs_per_frame",
        "launches_per_frame"}
    for row in rows[:2]:
        assert set(row) == common | {
            "train_steps_per_sec_per_chip", "frames_per_sec_per_chip",
            "steps_per_repeat", "syncs_per_step", "launches_per_step",
            "total_per_repeat"}
        assert np.isfinite(row["total_per_repeat"]).all()


def test_mains_raise_without_a_card(monkeypatch):
    def no_work(*_, **__):
        raise AssertionError("work began before the device was resolved")

    monkeypatch.setattr(bench, "flagship_cfg", no_work)
    monkeypatch.setattr(bench, "build_kernels", no_work)
    for main in (bench.main, bench_detail.main):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            main(["--toy"])


def test_a_failed_row_is_reported_and_main_exits_1(monkeypatch, capsys):
    ran = []

    def run(name, **kwargs):
        ran.append(name)
        if name == "topk64_jacobi_b1":
            raise RuntimeError("made to fail\nsecond line")
        return {"config": name}

    monkeypatch.setattr(bench_detail, "run_config", run)
    with pytest.raises(SystemExit) as exit_info:
        bench_detail.main(["--device", "cpu", "--toy", "topk64_jacobi_b"])
    assert exit_info.value.code == 1
    assert ran == ["topk64_jacobi_b1", "topk64_jacobi_b2", "topk64_jacobi_b4"]
    lines = _lines(capsys)
    assert {"config": "topk64_jacobi_b1",
            "error": "RuntimeError: made to fail"} in lines
    assert lines[-1] == {"failed_rows": ["topk64_jacobi_b1"]}
