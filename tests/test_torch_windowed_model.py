"""The windowed layer-1 serving path (DECODER.layer1_windowed_sampling) of
the port against the JAX package, on the same inputs and the same weights.
The weights are the port's seeded init, carried to flax by the JAX
package's converter and back by `port_state_dict_from_jax` (an exact round
trip, tests/test_torch_model.py); this spares a JAX init per config.

  * the toy configs of tools/make_golden.py, run windowed, against JAX's
    `model.apply(..., window_plan=plan)` at the golden tolerance classes of
    tests/test_golden.py: topk_jacobi_ptop4 with impl 'xla', and
    topk_jacobi with impl 'pallas_dma' and layer1_offset_clamp 1.0
    (halo 3), which must also match JAX's clamped gather;
  * `build_layer1_window_plan`: the same arrays as JAX's, and the clamp/halo
    guard;
  * `make_eval_step(..., with_escape_telemetry=True)`: pred and escaped mass.

The batch holds two items, so the plan is folded over the batch.
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
from mvgformer_tpu.models.mvgformer import \
    build_layer1_window_plan as jax_build_plan  # noqa: E402
from mvgformer_tpu.utils.torch_convert import convert_mvgformer_state_dict  # noqa: E402
from mvgformer_tpu_torch.core.infer import make_eval_step  # noqa: E402
from mvgformer_tpu_torch.data.synthetic import batch_from_jax  # noqa: E402
from mvgformer_tpu_torch.models.mvgformer import (  # noqa: E402
    MVGFormer, build_layer1_window_plan, layer1_window_plan_host)
from mvgformer_tpu_torch.utils.jax_convert import port_state_dict_from_jax  # noqa: E402

THRESHOLD = 0.1
# case -> (golden toy config, layer1_window_impl, layer1_offset_clamp)
CASES = {
    "ptop4_xla": ("topk_jacobi_ptop4", "xla", None),
    "jacobi_dma_clamp1": ("topk_jacobi", "pallas_dma", 1.0),
}


def _cfg(case):
    name, impl, clamp = CASES[case]
    cfg = make_golden.toy_cfg(**make_golden.CONFIGS[name])
    cfg.DECODER.layer1_windowed_sampling = True
    cfg.DECODER.layer1_window_impl = impl
    cfg.DECODER.layer1_offset_clamp = clamp
    return cfg


@functools.lru_cache(maxsize=None)
def _run(case):
    """One jitted JAX program per case: the windowed forward, and JAX's
    make_eval_step with telemetry or, where the case clamps, the clamped
    gather forward; the port loaded with the same weights."""
    cfg = _cfg(case)
    seeded = MVGFormer(cfg, generator=torch.Generator().manual_seed(3),
                       device="cpu")
    variables = jax.tree_util.tree_map(
        np.asarray, convert_mvgformer_state_dict(seeded.state_dict(), cfg))
    jm = JMVGFormer(cfg=cfg)
    batch = jax_make_batch(cfg, batch_size=2, seed=7, num_people=2)
    jplan = jax_build_plan(cfg, batch.view_data)
    step = jax_make_eval_step(cfg, jm, THRESHOLD, window_plan=jplan,
                              with_escape_telemetry=True)

    clamped = cfg.DECODER.layer1_offset_clamp is not None

    @functools.partial(jax.jit, compiler_options={
        "xla_backend_optimization_level": 0})
    def run(variables, batch):
        windowed = jm.apply(variables, batch, threshold=THRESHOLD,
                            window_plan=jplan)
        if clamped:
            return windowed, None, jm.apply(variables, batch,
                                            threshold=THRESHOLD)
        return windowed, step(variables["params"],
                              variables["batch_stats"], batch), None

    windowed, pred, gather = jax.tree_util.tree_map(
        np.asarray, run(variables, batch))
    model = MVGFormer(cfg, device="cpu")
    model.load_state_dict(port_state_dict_from_jax(variables, cfg))
    model.eval()
    tbatch = batch_from_jax(batch)
    return dict(cfg=cfg, batch=batch, tbatch=tbatch, jplan=jplan,
                windowed=windowed, pred=pred, gather=gather, model=model,
                plan=build_layer1_window_plan(cfg, tbatch.view_data,
                                              device="cpu"),
                host_plan=layer1_window_plan_host(cfg, tbatch.view_data))


def _assert_golden_classes(got, want):
    """The tolerance classes of tests/test_golden.py."""
    np.testing.assert_allclose(got["pred_logits"], want["pred_logits"],
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(got["pred_poses_2d"], want["pred_poses_2d"],
                               rtol=1e-3, atol=0.5)
    err = np.abs(got["pred_poses"] - want["pred_poses"])
    assert np.percentile(err, 99) < 2.0, np.percentile(err, 99)
    assert err.max() < 6.0, err.max()


@pytest.mark.parametrize("case", list(CASES))
def test_windowed_slice_matches_jax(case):
    r = _run(case)
    with torch.no_grad():
        outs = r["model"](r["tbatch"], threshold=THRESHOLD,
                          window_plan=r["plan"])
    assert len(outs) == len(r["windowed"])
    assert "escaped_mass" in outs[0]
    assert all("escaped_mass" not in o for o in outs[1:])
    wants = [r["windowed"]]
    if r["gather"] is not None:
        # the clamp is upstream of both samplers: the clamped window must
        # also match the clamped gather
        wants.append(r["gather"])
    for want_layers in wants:
        for got, want in zip(outs, want_layers):
            _assert_golden_classes(
                {k: v.numpy() for k, v in got.items()}, want)


@pytest.mark.parametrize("case", list(CASES))
def test_layer1_plan_matches_jax(case):
    """The host plan equals JAX's, dtypes included; the plan the entry
    point places on a device holds the same values."""
    r = _run(case)
    got, want, placed = r["host_plan"], r["jplan"], r["plan"]
    assert (got.halo, got.impl) == (want.halo, want.impl)
    assert (placed.halo, placed.impl) == (want.halo, want.impl)
    if CASES[case][2] == 1.0:
        assert got.halo == 3  # ceil(1.0) + 2
    for g, w, p in zip(got.levels, want.levels, placed.levels):
        for field in w._fields:
            a, b = getattr(g, field), getattr(w, field)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, field
                np.testing.assert_array_equal(a, b, err_msg=field)
                t = getattr(p, field)
                assert isinstance(t, torch.Tensor), field
                np.testing.assert_array_equal(t.numpy(), b, err_msg=field)
            else:
                assert a == b == getattr(p, field), field


def test_clamp_halo_guard():
    """A halo too small for the clamp is refused when the plan is built:
    escaped samples would silently read zero."""
    r = _run("ptop4_xla")
    cfg = _cfg("ptop4_xla")
    cfg.DECODER.layer1_offset_clamp = 4.0
    cfg.DECODER.layer1_window_halo = 3
    with pytest.raises(ValueError, match="layer1_offset_clamp"):
        build_layer1_window_plan(cfg, r["tbatch"].view_data, device="cpu")
    with pytest.raises(ValueError, match="layer1_offset_clamp"):
        jax_build_plan(cfg, r["batch"].view_data)


def test_eval_step_telemetry_matches_jax():
    r = _run("ptop4_xla")
    want, want_esc = r["pred"]
    pred, esc = make_eval_step(r["cfg"], r["model"], THRESHOLD,
                               window_plan=r["plan"],
                               with_escape_telemetry=True)(r["tbatch"])
    pred = pred.numpy()
    assert pred.shape == want.shape == (2, 16, 15, 5)
    err = np.abs(pred[..., :3] - want[..., :3])
    assert np.percentile(err, 99) < 2.0 and err.max() < 6.0
    np.testing.assert_allclose(pred[..., 4], want[..., 4], rtol=1e-3,
                               atol=1e-4)
    assert esc.dtype == torch.float32 and esc.dim() == 0
    np.testing.assert_allclose(float(esc), float(want_esc), rtol=1e-5,
                               atol=1e-6)
