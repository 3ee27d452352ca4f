"""The port's corner-table gather-reduce and corner sampler (the plain
versions of kernels B3 on the CPU) against JAX's:

  * `deform_gather_reduce` against JAX's one-hot Pallas form
    (mvgformer_tpu/ops/onehot_gather.py, interpret mode, blocks and windows
    made small as in tests/test_onehot_gather.py) on the cases of that
    file: clustered rows (the kernel path), uniform rows (escapes beyond
    capacity: the fallback), a few far rows (the escape repair), border
    rows 0 and R - 1, and a sample count that is no multiple of the block;
    forward at float32 atol 1e-6 (four products summed in float32 in
    another order), grad_tables and grad_w4 against JAX's custom VJP at
    float32 atol 1e-5 (sums over up to a few hundred samples per row);
  * `deform_sample_corner`, forward and the gradients with respect to the
    value, the locations and the attention weights, against JAX's under
    all four settings of MVG_TABLE_IMPL x MVG_SAMPLER_IMPL, at a shape
    where JAX takes its per-pair route and its one-hot gather (N*H*Lq*P >=
    131072 and Lq*P >= 32768): float32 atol 1e-5, for a gradient atol
    1e-5 times its largest entry where that exceeds 1. The location
    gradients carry a factor of the level's width: entries up to ~1.4e3
    are sums of terms that large, so a small entry inherits their float32
    rounding (one ulp of 1.4e3 is 1.2e-4);
  * the port's sampler (which runs unchunked for every
    TRAIN.SAMPLE_CHUNKS) against JAX's chunked sampler.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvgformer_tpu.ops import onehot_gather as og
from mvgformer_tpu.ops import sampling as jsampling
from mvgformer_tpu_torch.ops import sampling, table_gather


@pytest.fixture
def small_onehot(monkeypatch):
    monkeypatch.setenv("MVG_ONEHOT_INTERPRET", "1")
    monkeypatch.setattr(og, "BS", 128)
    monkeypatch.setattr(og, "W", 256)
    monkeypatch.setattr(og, "E_CAP", 64)


def _inputs(seed, case, NH=2, R=1024, S=512, D=16):
    rng = np.random.RandomState(seed)
    tables = rng.randn(NH, R, 4 * D).astype(np.float32)
    if case == "uniform":
        idx = rng.randint(0, R, (NH, S))
    else:
        # clustered rows: block-sorted spans well under the window
        centers = rng.randint(0, R - 64, (NH, S // 64, 1))
        idx = (centers + rng.randint(0, 48, (NH, S // 64, 64))).reshape(
            NH, S)
        if case == "far":
            idx[:, ::37] = (idx[:, ::37] + 700) % R
        elif case == "border":
            idx[:, ::5] = 0
            idx[:, 1::5] = R - 1
    w4 = rng.randn(NH, S, 4).astype(np.float32)
    return tables, np.clip(idx, 0, R - 1).astype(np.int32), w4


CASES = ["clustered", "uniform", "far", "border"]


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax(small_onehot, case):
    tables, idx, w4 = _inputs(1, case)
    want = np.asarray(og.deform_gather_reduce(
        jnp.asarray(tables), jnp.asarray(idx), jnp.asarray(w4)))
    got = table_gather.deform_gather_reduce(
        torch.from_numpy(tables), torch.from_numpy(idx),
        torch.from_numpy(w4))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_forward_matches_jax_fallback_shape(small_onehot):
    """S not a multiple of the block: JAX takes its plain gather."""
    tables, idx, w4 = _inputs(2, "uniform", S=500)
    want = np.asarray(og.deform_gather_reduce(
        jnp.asarray(tables), jnp.asarray(idx), jnp.asarray(w4)))
    got = table_gather.gather_reduce_forward(
        torch.from_numpy(tables), torch.from_numpy(idx),
        torch.from_numpy(w4))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", CASES)
def test_grads_match_jax(small_onehot, case):
    tables, idx, w4 = _inputs(3, case)
    ct = np.random.RandomState(4).randn(2, 512, 16).astype(np.float32)
    _, vjp = jax.vjp(lambda t, w: og.deform_gather_reduce(
        t, jnp.asarray(idx), w), jnp.asarray(tables), jnp.asarray(w4))
    want_t, want_w = (np.asarray(g) for g in vjp(jnp.asarray(ct)))
    tt = torch.from_numpy(tables).requires_grad_(True)
    tw = torch.from_numpy(w4).requires_grad_(True)
    table_gather.deform_gather_reduce(tt, torch.from_numpy(idx), tw).backward(
        torch.from_numpy(ct))
    np.testing.assert_allclose(tt.grad.numpy(), want_t, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), want_w, rtol=0, atol=1e-5)


def test_backward_wrapper_equals_plain_autograd():
    """The CPU backward of the kernel wrapper against autograd of the plain
    gather-reduce (the two routes the card compares)."""
    tables, idx, w4 = _inputs(5, "border")
    ct = torch.from_numpy(
        np.random.RandomState(6).randn(2, 512, 16).astype(np.float32))
    tt = torch.from_numpy(tables).requires_grad_(True)
    tw = torch.from_numpy(w4).requires_grad_(True)
    table_gather.deform_gather_reduce_plain(
        tt, torch.from_numpy(idx), tw).backward(ct)
    gt, gw = table_gather.gather_reduce_backward(
        torch.from_numpy(tables), torch.from_numpy(idx),
        torch.from_numpy(w4), ct)
    np.testing.assert_allclose(gt.numpy(), tt.grad.numpy(), atol=1e-5)
    np.testing.assert_allclose(gw.numpy(), tw.grad.numpy(), atol=1e-5)


SAMPLER_SHAPES = ((32, 60), (16, 30))


@pytest.fixture(scope="module")
def sampler_inputs():
    rng = np.random.RandomState(7)
    N, Lq, H, D, P = 2, 8192, 2, 16, 4
    total = sum(h * w for h, w in SAMPLER_SHAPES)
    value = rng.randn(N, total, H, D).astype(np.float32)
    locs = rng.uniform(-0.1, 1.1, (N, Lq, H, len(SAMPLER_SHAPES), P,
                                   2)).astype(np.float32)
    aw = rng.rand(N, Lq, H, len(SAMPLER_SHAPES), P).astype(np.float32)
    ct = rng.randn(N, Lq, H * D).astype(np.float32)
    tv = torch.from_numpy(value).requires_grad_(True)
    tl = torch.from_numpy(locs).requires_grad_(True)
    ta = torch.from_numpy(aw).requires_grad_(True)
    out = sampling.deform_sample_corner(tv, SAMPLER_SHAPES, tl, ta)
    out.backward(torch.from_numpy(ct))
    port = (out.detach().numpy(), tv.grad.numpy(), tl.grad.numpy(),
            ta.grad.numpy())
    return (value, locs, aw, ct), port


@pytest.mark.parametrize("sampler_impl", ["", "onehot"])
@pytest.mark.parametrize("table_impl", ["xla", "pallas"])
def test_corner_sampler_matches_jax(monkeypatch, sampler_inputs, table_impl,
                                    sampler_impl):
    monkeypatch.setenv("MVG_TABLE_IMPL", table_impl)
    monkeypatch.setenv("MVG_SAMPLER_IMPL", sampler_impl)
    monkeypatch.setenv("MVG_ONEHOT_INTERPRET", "1")
    selects = []
    select = og._onehot_select
    monkeypatch.setattr(og, "_onehot_select",
                        lambda *a: selects.append(1) or select(*a))
    (value, locs, aw, ct), port = sampler_inputs

    def f(v, lc, a):
        return jsampling.deform_sample_corner(v, SAMPLER_SHAPES, lc, a)

    out, vjp = jax.vjp(f, jnp.asarray(value), jnp.asarray(locs),
                       jnp.asarray(aw))
    want = (np.asarray(out),) + tuple(
        np.asarray(g) for g in vjp(jnp.asarray(ct)))
    # the one-hot route really ran
    assert bool(selects) == (sampler_impl == "onehot")
    np.testing.assert_allclose(port[0], want[0], rtol=0, atol=1e-5)
    for got, exp in zip(port[1:], want[1:]):
        np.testing.assert_allclose(
            got, exp, rtol=0, atol=1e-5 * max(1.0, np.abs(exp).max()))


def test_query_chunks_not_ported():
    """TRAIN.SAMPLE_CHUNKS (once refused here, hence the name): the port
    runs its corner sampler unchunked for any chunk count, so it must give
    what JAX's chunked sampler (query_chunks = 4, a lax.scan over query
    chunks) gives: forward and the gradients with respect to the value,
    the locations and the attention weights, at the tolerances of
    test_corner_sampler_matches_jax."""
    rng = np.random.RandomState(3)
    N, Lq, H, D, P, chunks = 2, 96, 2, 8, 4, 4
    total = sum(h * w for h, w in SAMPLER_SHAPES)
    value = rng.randn(N, total, H, D).astype(np.float32)
    locs = rng.uniform(-0.1, 1.1, (N, Lq, H, len(SAMPLER_SHAPES), P,
                                   2)).astype(np.float32)
    aw = rng.rand(N, Lq, H, len(SAMPLER_SHAPES), P).astype(np.float32)
    ct = rng.randn(N, Lq, H * D).astype(np.float32)

    def f(v, lc, a):
        return jsampling.deform_sample_corner(v, SAMPLER_SHAPES, lc, a,
                                              query_chunks=chunks)

    out, vjp = jax.vjp(f, jnp.asarray(value), jnp.asarray(locs),
                       jnp.asarray(aw))
    want = (np.asarray(out),) + tuple(
        np.asarray(g) for g in vjp(jnp.asarray(ct)))
    tv, tl, ta = (torch.from_numpy(x).requires_grad_(True)
                  for x in (value, locs, aw))
    got = sampling.deform_sample_corner(tv, SAMPLER_SHAPES, tl, ta)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), want[0], rtol=0,
                               atol=1e-5)
    for g, exp in zip((tv.grad, tl.grad, ta.grad), want[1:]):
        np.testing.assert_allclose(
            g.numpy(), exp, rtol=0, atol=1e-5 * max(1.0, np.abs(exp).max()))
