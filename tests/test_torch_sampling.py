"""Deformable sampling: the port's plain version against the JAX package's
deform_sample, deform_sample_corner and the Pallas kernel (interpret mode),
and the kernel wrapper's CPU behaviour.

Tolerance: rtol 1e-5 / atol 1e-4 in float32 (sums over levels and points
taken in another order). The CUDA kernel itself is held against the plain
version in tests/test_torch_kernel.py, on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mvgformer_tpu.ops import sampling as jsamp
from mvgformer_tpu.ops.pallas_deform import deform_sample_pallas
from mvgformer_tpu_torch.ops import deform_attn
from mvgformer_tpu_torch.ops import sampling as tsamp

SHAPES = ((16, 30), (8, 15), (4, 8))
RTOL, ATOL = 1e-5, 1e-4


def _inputs(rng, N=2, Lq=12, H=4, D=8, P=4, shapes=SHAPES, lo=-0.2, hi=1.2):
    len_in = sum(h * w for h, w in shapes)
    value = rng.randn(N, len_in, H, D).astype(np.float32)
    locs = rng.uniform(lo, hi, size=(N, Lq, H, len(shapes), P, 2)
                       ).astype(np.float32)
    w = rng.rand(N, Lq, H, len(shapes), P).astype(np.float32)
    w /= w.sum(axis=(-1, -2), keepdims=True)
    return value, locs, w


def _border(locs, shapes):
    """Put samples in the border bands: x in (-1, 0) px for the first third
    of the queries, y in [h-1, h) px for the second third."""
    locs = locs.copy()
    Lq = locs.shape[1]
    for lvl, (h, w) in enumerate(shapes):
        u = np.linspace(0.05, 0.95, locs[:, :Lq // 3, :, lvl, :, 0].size)
        locs[:, :Lq // 3, :, lvl, :, 0] = ((-u + 0.5) / w).reshape(
            locs[:, :Lq // 3, :, lvl, :, 0].shape)
        sl = locs[:, Lq // 3:2 * Lq // 3, :, lvl, :, 1]
        u = np.linspace(0.0, 0.95, sl.size)
        locs[:, Lq // 3:2 * Lq // 3, :, lvl, :, 1] = (
            (h - 1 + u + 0.5) / h).reshape(sl.shape)
    return locs


def _jax_impls():
    return {
        "deform_sample": jsamp.deform_sample,
        "deform_sample_corner": jsamp.deform_sample_corner,
        "deform_sample_pallas": lambda *a: deform_sample_pallas(
            *a, interpret=True),
    }


@pytest.mark.parametrize("impl", ["deform_sample", "deform_sample_corner",
                                  "deform_sample_pallas"])
@pytest.mark.parametrize("case", ["uniform", "border", "far_outside"])
def test_plain_matches_jax(rng, impl, case):
    value, locs, w = _inputs(rng, N=1, Lq=9, H=2, D=8, P=3)
    if case == "border":
        locs = _border(locs, SHAPES)
    elif case == "far_outside":
        locs[:, ::2] = 5.0
        locs[:, 1::2] = -4.0
    want = np.asarray(_jax_impls()[impl](
        jnp.asarray(value), SHAPES, jnp.asarray(locs), jnp.asarray(w)))
    got = tsamp.deform_sample(torch.from_numpy(value), SHAPES,
                              torch.from_numpy(locs), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if case == "far_outside":
        np.testing.assert_array_equal(got.numpy(), 0.0)


@pytest.mark.parametrize("L,P,D", [(1, 2, 8), (2, 3, 8), (3, 4, 32),
                                   (3, 8, 8)])
def test_plain_matches_jax_shapes(rng, L, P, D):
    shapes = SHAPES[:L]
    value, locs, w = _inputs(rng, N=2, Lq=10, H=2, D=D, P=P, shapes=shapes)
    want = np.asarray(jsamp.deform_sample(
        jnp.asarray(value), shapes, jnp.asarray(locs), jnp.asarray(w)))
    got = tsamp.deform_sample(torch.from_numpy(value), shapes,
                              torch.from_numpy(locs), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_plain_ignores_nonfinite_locations(rng):
    """NaN, +-inf and huge locations contribute nothing (the kernel's rule);
    the finite samples of the same query still count."""
    value, locs, w = _inputs(rng, N=1, Lq=4, H=2, D=8, P=3)
    bad = locs.copy()
    bad[0, 0, :, :, 0, 0] = np.nan
    bad[0, 1, :, :, 0, 1] = np.inf
    bad[0, 2, :, :, 0, 0] = -np.inf
    bad[0, 3, :, :, 0, 1] = 1e20
    ref = locs.copy()
    ref[0, :, :, :, 0] = 50.0  # the same samples, plainly off the map
    got = tsamp.deform_sample(torch.from_numpy(value), SHAPES,
                              torch.from_numpy(bad), torch.from_numpy(w))
    want = tsamp.deform_sample(torch.from_numpy(value), SHAPES,
                               torch.from_numpy(ref), torch.from_numpy(w))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=0)


def test_bilinear_sample_matches_jax(rng):
    h, w, D = 7, 11, 5
    value = rng.randn(2, h * w, D).astype(np.float32)
    x = rng.uniform(-2, w + 1, size=(2, 40)).astype(np.float32)
    y = rng.uniform(-2, h + 1, size=(2, 40)).astype(np.float32)
    want = np.asarray(jsamp.bilinear_sample(
        jnp.asarray(value), jnp.asarray(x), jnp.asarray(y), h, w))
    got = tsamp.bilinear_sample(torch.from_numpy(value), torch.from_numpy(x),
                                torch.from_numpy(y), h, w)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_flatten_feature_levels_matches_jax(rng):
    feats = [rng.randn(2, 3, h, w).astype(np.float32) for h, w in SHAPES]
    want, want_shapes = jsamp.flatten_feature_levels(
        [jnp.asarray(f) for f in feats])
    got, got_shapes = tsamp.flatten_feature_levels(
        [torch.from_numpy(f) for f in feats])
    assert got_shapes == want_shapes
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrapper_on_cpu_uses_plain_version(rng):
    """A CPU tensor goes to the plain version; the kernel's launch counter
    does not move."""
    value, locs, w = _inputs(rng)
    args = (torch.from_numpy(value), SHAPES, torch.from_numpy(locs),
            torch.from_numpy(w))
    deform_attn.deform_sample.launches = 0
    got = deform_attn.deform_sample(*args)
    assert deform_attn.deform_sample.launches == 0
    np.testing.assert_array_equal(got.numpy(),
                                  tsamp.deform_sample(*args).numpy())


def test_wrapper_checks_shapes(rng):
    value, locs, w = _inputs(rng)
    v, l, a = (torch.from_numpy(x) for x in (value, locs, w))
    with pytest.raises(ValueError):
        deform_attn.deform_sample(v, SHAPES[:2], l[..., :2, :, :], a)
    with pytest.raises(ValueError):
        deform_attn.deform_sample(v[:, :-1], SHAPES, l, a)
    with pytest.raises(ValueError):
        deform_attn.deform_sample(v, SHAPES, l, a[..., :-1])
