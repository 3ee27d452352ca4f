"""ProjAttn: the port against the JAX module on the same inputs and weights,
with and without point-top-m, at the JAX init (all attention weights equal,
so point-top-m is pure tie-breaking) and with perturbed weights.

Tolerance: rtol 1e-4 / atol 1e-4 in float32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvgformer_tpu.ops.projattn import ProjAttn as JProjAttn
from mvgformer_tpu.ops.projattn import radial_offsets_bias_init
from mvgformer_tpu_torch.ops.projattn import (ProjAttn, radial_offsets_bias,
                                              top_indices)

SHAPES = ((16, 30), (8, 15), (4, 8))
D_MODEL, HEADS, POINTS = 32, 4, 6
TOL = 1e-4


def _setup(rng, perturb: bool):
    N, Lq = 3, 11
    src = [rng.randn(N, h, w, D_MODEL).astype(np.float32) for h, w in SHAPES]
    query = rng.randn(N, Lq, D_MODEL).astype(np.float32)
    refs = rng.uniform(0.05, 0.95, size=(N, Lq, len(SHAPES), 2)).astype(
        np.float32)
    jmod = JProjAttn(d_model=D_MODEL, n_levels=1, n_heads=HEADS,
                     n_points=POINTS)
    jargs = (jnp.asarray(query), jnp.asarray(refs),
             [jnp.asarray(s) for s in src], SHAPES)
    params = jax.tree_util.tree_map(
        np.array, jmod.init(jax.random.PRNGKey(0), *jargs))
    p = params["params"]
    if perturb:
        for name, scale in (("attention_weights", 0.5),
                            ("sampling_offsets", 0.05)):
            p[name]["kernel"] = (scale * rng.randn(
                *p[name]["kernel"].shape)).astype(np.float32)
            p[name]["bias"] = p[name]["bias"] + (scale * rng.randn(
                *p[name]["bias"].shape)).astype(np.float32)
    tmod = ProjAttn(D_MODEL, n_levels=1, n_heads=HEADS, n_points=POINTS)
    tmod.load_state_dict({
        f"{name}.{tk}": torch.from_numpy(
            p[name][jk].T.copy() if jk == "kernel" else p[name][jk])
        for name in ("sampling_offsets", "attention_weights", "rayconv",
                     "output_proj")
        for tk, jk in (("weight", "kernel"), ("bias", "bias"))})
    targs = (torch.from_numpy(query), torch.from_numpy(refs),
             [torch.from_numpy(s) for s in src], SHAPES)
    return jmod, params, jargs, tmod, targs


@pytest.mark.parametrize("perturb", [False, True],
                         ids=["jax_init", "perturbed"])
@pytest.mark.parametrize("topm", [None, 2, 4])
def test_projattn_matches_jax(rng, perturb, topm):
    jmod, params, jargs, tmod, targs = _setup(rng, perturb)
    want = np.asarray(jmod.apply(params, *jargs, point_topm=topm))
    with torch.no_grad():
        got = tmod(*targs, point_topm=topm)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_topm_ties_pick_lowest_index_like_jax():
    """At the JAX init every softmax weight is 1/(L*P): the top-m choice is
    tie-breaking alone, and must follow jax.lax.top_k (lowest index)."""
    x = np.full((2, 3, 24), 1.0 / 24, np.float32)
    x[1, 2, 7] = 0.5
    _, want = jax.lax.top_k(jnp.asarray(x), 4)
    got = top_indices(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_top_indices_matches_jax_on_distinct_values(rng):
    x = rng.randn(4, 5, 9).astype(np.float32)
    _, want = jax.lax.top_k(jnp.asarray(x), 3)
    np.testing.assert_array_equal(
        top_indices(torch.from_numpy(x), 3).numpy(), np.asarray(want))


def test_fresh_init_matches_jax_init():
    """Zero offset and weight kernels, the radial offsets bias."""
    mod = ProjAttn(D_MODEL, n_levels=1, n_heads=HEADS, n_points=POINTS,
                   generator=torch.Generator().manual_seed(0))
    want = np.asarray(radial_offsets_bias_init(HEADS, 1, POINTS)(
        None, (HEADS * POINTS * 2,)))
    np.testing.assert_allclose(mod.sampling_offsets.bias.detach().numpy(),
                               want, atol=1e-6)
    np.testing.assert_allclose(radial_offsets_bias(HEADS, 2, 3).numpy(),
                               np.asarray(radial_offsets_bias_init(
                                   HEADS, 2, 3)(None, (HEADS * 12,))),
                               atol=1e-6)
    for lin in (mod.sampling_offsets, mod.attention_weights):
        assert torch.count_nonzero(lin.weight) == 0
    assert torch.count_nonzero(mod.attention_weights.bias) == 0


@pytest.mark.parametrize("topm", [None, 4])
def test_projattn_offset_clamp_matches_jax(rng, topm):
    """DECODER.layer1_offset_clamp without a window plan: the offsets are
    clamped in each level's pixels before the division by (w, h), and the
    gather samples at the clamped locations."""
    jmod, params, jargs, tmod, targs = _setup(rng, perturb=True)
    want = np.asarray(jmod.apply(params, *jargs, offset_clamp_px=0.5,
                                 point_topm=topm))
    with torch.no_grad():
        got, escaped = tmod(*targs, offset_clamp_px=0.5, point_topm=topm)
        free, _ = tmod(*targs, point_topm=topm)
    assert escaped is None
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert np.abs(free.numpy() - want).max() > 10 * TOL  # the clamp binds
