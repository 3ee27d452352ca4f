"""The port's windowed layer-1 sampler against the JAX package's, on the
same inputs (made with numpy from a seed):

  * `build_window_plan` and `_tile_windows`: exactly equal arrays, over
    several tile/halo values, centers near and past the borders, and views
    with unequal row counts;
  * `window_sample`, impl 'xla' with float32 weight rows, at 1e-4: within
    the halo, at the border, a small halo under clamped offsets, and the
    plan folded over a batch; impls 'pallas' and 'pallas_dma' at the
    bfloat16 class of tests/test_window_sampling.py (JAX's Pallas kernels
    emit bfloat16 rows), 4e-2 * max |ref|;
  * the escaped mass at rtol 1e-5, for a sample that leaves its window, and
    for a sample inside the widened 'pallas_dma' window (Kx) but outside K;
  * the plain versions of the two window kernels against JAX's Pallas
    kernels (interpret mode off the TPU) on identical operands, at the
    bfloat16 class, and against each other: B5's on a padded map equals
    B4's on the tiles cut from it at the same origins;
  * CPU calls launch no kernel.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvgformer_tpu.ops import window_sampling as jws
from mvgformer_tpu.ops.window_dma import window_block_dma as jax_dma
from mvgformer_tpu.ops.window_pallas import \
    window_block_matmul as jax_block
from mvgformer_tpu_torch.ops import deform_attn, window_block, window_dma
from mvgformer_tpu_torch.ops import window_sampling as tws

SHAPES = ((24, 40), (12, 20), (6, 10))
V, Lq, H, P, D = 2, 50, 4, 3, 8
L = len(SHAPES)
BF16_CLASS = 4e-2  # bf16 weight rows and bf16 kernel output on the JAX side


def make_inputs(seed, offset_px, center_lo=0.05, center_hi=0.95, views=V):
    """value, locations, weights and static centers: each sample lies
    within +-offset_px of its query's center on every level."""
    rng = np.random.RandomState(seed)
    len_in = sum(h * w for h, w in SHAPES)
    value = rng.randn(views, len_in, H, D).astype(np.float32)
    centers = rng.uniform(center_lo, center_hi, (views, Lq, 2)).astype(
        np.float32)
    if views > 1:
        # view 1 crowds into one corner: its row count differs from view 0
        centers[1, : Lq // 2] = rng.uniform(0.1, 0.2, (Lq // 2, 2))
    locs = np.zeros((views, Lq, H, L, P, 2), np.float32)
    centers_px = np.zeros((views, Lq, L, 2), np.float32)
    for lvl, (h, w) in enumerate(SHAPES):
        wh = np.array([w, h], np.float32)
        off = rng.uniform(-offset_px, offset_px,
                          (views, Lq, H, P, 2)).astype(np.float32)
        locs[:, :, :, lvl] = centers[:, :, None, None] + off / wh
        centers_px[:, :, lvl] = centers * wh - 0.5
    aw = rng.rand(views, Lq, H, L, P).astype(np.float32)
    aw /= aw.sum(axis=(3, 4), keepdims=True)
    return value, locs, aw, centers_px


def _jax_sample(value, locs, aw, plan, impl):
    out, esc = jax.jit(lambda v, l, a: jws.window_sample(
        v, SHAPES, l, a, plan, row_dtype=jnp.float32, impl=impl))(
        jnp.asarray(value), jnp.asarray(locs), jnp.asarray(aw))
    return np.asarray(out, np.float32), float(esc)


def _port_sample(value, locs, aw, plan, impl):
    out, esc = tws.window_sample(
        torch.from_numpy(value), SHAPES, torch.from_numpy(locs),
        torch.from_numpy(aw), plan, row_dtype=torch.float32, impl=impl)
    assert out.dtype == torch.float32 and esc.dim() == 0
    return out.numpy(), float(esc)


def _assert_plans_equal(got, want):
    assert (got.halo, got.impl) == (want.halo, want.impl)
    assert len(got.levels) == len(want.levels)
    for g, w in zip(got.levels, want.levels):
        for field in w._fields:
            a, b = getattr(g, field), getattr(w, field)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, field
                np.testing.assert_array_equal(a, b, err_msg=field)
            else:
                assert a == b, field
        # JAX derives the 'pallas_dma' width inside window_sample
        ox = (w.block_tile % w.grid_hw[1]) * w.tile + 2
        assert g.Kx == -(-(w.K + int((ox % 8).max())) // 8) * 8


@pytest.mark.parametrize("tile,halo", [(4, 6), (8, 10), (4, 4), (8, 6)])
@pytest.mark.parametrize("where", ["inside", "border", "past_border"])
def test_plan_matches_jax(tile, halo, where):
    lo, hi = {"inside": (0.05, 0.95), "border": (0.0, 0.06),
              "past_border": (-0.2, 1.2)}[where]
    _, _, _, centers_px = make_inputs(tile * halo, 2.0, lo, hi)
    for impl in ("xla", "pallas_dma"):
        _assert_plans_equal(
            tws.build_window_plan(centers_px, SHAPES, tile=tile, halo=halo,
                                  impl=impl),
            jws.build_window_plan(centers_px, SHAPES, tile=tile, halo=halo,
                                  impl=impl))
    rows = [int(lp.row_valid[v].sum()) for lp in tws.build_window_plan(
        centers_px, SHAPES, tile=tile, halo=halo).levels for v in range(V)]
    assert all(r == Lq for r in rows)


@pytest.mark.parametrize("tile,halo", [(4, 6), (8, 10), (4, 4)])
def test_tile_windows_match_jax(tile, halo):
    value, _, _, centers_px = make_inputs(1, 2.0)
    jplan = jws.build_window_plan(centers_px, SHAPES, tile=tile, halo=halo)
    tplan = tws.build_window_plan(centers_px, SHAPES, tile=tile, halo=halo)
    start = 0
    for lvl, (h, w) in enumerate(SHAPES):
        v_map = value[0, start:start + h * w].reshape(h, w, H, D)
        start += h * w
        want = np.asarray(jws._tile_windows(jnp.asarray(v_map),
                                            jplan.levels[lvl]))
        got = tws._tile_windows(torch.from_numpy(v_map), tplan.levels[lvl])
        np.testing.assert_array_equal(got.numpy(), want)
        # views batched in front give each view's windows
        both = tws._tile_windows(torch.from_numpy(np.stack([v_map, -v_map])),
                                 tplan.levels[lvl])
        np.testing.assert_array_equal(both[1].numpy(), -want)


# name -> (seed, offset px, center range, tile, halo, views)
SAMPLE_CASES = {
    "within_halo": (0, 3.0, (0.05, 0.95), 4, 6, V),
    "border": (3, 3.0, (0.0, 0.06), 4, 6, V),
    "small_halo_clamped": (4, 1.9, (0.05, 0.95), 4, 4, V),
    "batch_fold": (6, 3.0, (0.05, 0.95), 4, 6, 2 * V),
}


@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_window_sample_xla_matches_jax(case):
    seed, off, (lo, hi), tile, halo, views = SAMPLE_CASES[case]
    value, locs, aw, centers_px = make_inputs(seed, off, lo, hi, views)
    if views != V:
        # a plan of V views serves a view-major fold of V views x B items
        B = views // V
        locs = np.concatenate([locs[:V]] * B).reshape(
            B, V, *locs.shape[1:]).swapaxes(0, 1).reshape(locs.shape)
        centers_px = centers_px[:V]
    jplan = jws.build_window_plan(centers_px, SHAPES, tile=tile, halo=halo)
    tplan = tws.build_window_plan(centers_px, SHAPES, tile=tile, halo=halo)
    want, want_esc = _jax_sample(value, locs, aw, jplan, "xla")
    got, esc = _port_sample(value, locs, aw, tplan, "xla")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert esc < 1e-5 and want_esc < 1e-5
    # the plan moved to a device once gives the same result
    moved, _ = _port_sample(value, locs, aw, tplan.to("cpu"), "xla")
    np.testing.assert_array_equal(moved, got)


@pytest.mark.parametrize("impl", ["pallas", "pallas_dma"])
def test_window_sample_kernel_impls_match_jax(impl):
    value, locs, aw, centers_px = make_inputs(5, 3.0)
    jplan = jws.build_window_plan(centers_px, SHAPES, tile=4, halo=6,
                                  impl=impl)
    tplan = tws.build_window_plan(centers_px, SHAPES, tile=4, halo=6,
                                  impl=impl)
    want, want_esc = _jax_sample(value, locs, aw, jplan, impl)
    got, esc = _port_sample(value, locs, aw, tplan, impl)
    assert np.abs(got - want).max() < BF16_CLASS * np.abs(want).max()
    assert esc < 1e-5 and want_esc < 1e-5


def test_escaped_mass_matches_jax():
    """A sample pushed far out of its window but inside the map reads zero,
    and its attention weight is the escaped mass."""
    value, locs, aw, centers_px = make_inputs(2, 0.5)
    locs = locs.copy()
    locs[0, 7, 1, 0, 0] = np.array([0.5, 0.5]) + 0.45
    jplan = jws.build_window_plan(centers_px, SHAPES, tile=4, halo=6)
    tplan = tws.build_window_plan(centers_px, SHAPES, tile=4, halo=6)
    want, want_esc = _jax_sample(value, locs, aw, jplan, "xla")
    got, esc = _port_sample(value, locs, aw, tplan, "xla")
    np.testing.assert_allclose(esc, want_esc, rtol=1e-5)
    np.testing.assert_allclose(esc, aw[0, 7, 1, 0, 0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _escape_k_not_kx():
    """Inputs with one sample outside its K window but inside the widened
    'pallas_dma' window: 4.5 px left of a block origin that sits 6 px right
    of its 8-aligned origin."""
    value, locs, aw, centers_px = make_inputs(8, 0.5)
    plan = tws.build_window_plan(centers_px, SHAPES, tile=4, halo=6)
    lp = plan.levels[0]
    pos = lp.inv_perm[0]
    ox = lp.row_origin[0, pos, 0]
    q = int(np.flatnonzero((ox % 8 == 6) & (ox >= 16))[0])
    h, w = SHAPES[0]
    px = ox[q] - 4.5 - lp.pad  # map pixels
    locs = locs.copy()
    locs[0, q, 2, 0, 1, 0] = (px + 0.5) / w
    return value, locs, aw, centers_px, aw[0, q, 2, 0, 1]


@pytest.mark.parametrize("impl", ["pallas", "pallas_dma"])
def test_escape_inside_kx_outside_k_matches_jax(impl):
    value, locs, aw, centers_px, weight = _escape_k_not_kx()
    jplan = jws.build_window_plan(centers_px, SHAPES, tile=4, halo=6,
                                  impl=impl)
    tplan = tws.build_window_plan(centers_px, SHAPES, tile=4, halo=6,
                                  impl=impl)
    want, want_esc = _jax_sample(value, locs, aw, jplan, impl)
    got, esc = _port_sample(value, locs, aw, tplan, impl)
    np.testing.assert_allclose(esc, want_esc, rtol=1e-5, atol=1e-7)
    if impl == "pallas":
        np.testing.assert_allclose(esc, weight, rtol=1e-5)
    else:
        assert esc < 1e-6  # the widened window still covers it
    assert np.abs(got - want).max() < BF16_CLASS * np.abs(want).max()


def _kernel_operands(seed, K, Kw, nrows, block_rows, n_win):
    rng = np.random.RandomState(seed)
    rel = np.concatenate([
        rng.uniform(-1.5, K + 0.5, (nrows, H, P)),
        rng.uniform(-1.5, Kw + 0.5, (nrows, H, P)),
        rng.rand(nrows, H, P)], axis=-1).astype(np.float32)
    rel = rel.reshape(nrows, H * 3 * P)
    index = rng.randint(0, n_win, nrows // block_rows).astype(np.int32)
    return rng, rel, index


def test_window_block_plain_matches_jax_kernel():
    K, nrows, block_rows, n_tiles = 6, 48, 16, 5
    rng, rel, bt = _kernel_operands(0, K, K, nrows, block_rows, n_tiles)
    tiles = rng.randn(n_tiles, K * K, H * D).astype(np.float32)
    want = np.asarray(jax_block(
        jnp.asarray(tiles, jnp.bfloat16), jnp.asarray(rel), jnp.asarray(bt),
        K=K, H=H, P=P, D=D, block_rows=block_rows), np.float32)
    got = window_block.window_block_matmul(
        torch.from_numpy(tiles).bfloat16(), torch.from_numpy(rel),
        torch.from_numpy(bt), K=K, H=H, P=P, D=D, block_rows=block_rows)
    assert got.dtype == torch.bfloat16 and got.shape == (nrows, H * D)
    assert np.abs(got.float().numpy() - want).max() < (
        BF16_CLASS * np.abs(want).max())


def test_window_dma_plain_matches_jax_kernel():
    K, Kx, nrows, block_rows, views = 6, 16, 48, 16, 3
    hp, wp = 20, 40
    rng, rel, vix = _kernel_operands(1, K, Kx, nrows, block_rows, views)
    pmap = rng.randn(views, hp, wp, H * D).astype(np.float32)
    y0 = rng.randint(0, hp - K + 1, vix.shape)
    x0 = 8 * rng.randint(0, (wp - Kx) // 8 + 1, vix.shape)
    origins = np.stack([vix, y0, x0], -1).astype(np.int32)
    jorigins = origins.copy()
    jorigins[:, 2] //= 8  # the JAX wrapper takes x0 / 8
    want = np.asarray(jax_dma(
        jnp.asarray(pmap, jnp.bfloat16), jnp.asarray(rel),
        jnp.asarray(jorigins), K=K, H=H, P=P, D=D, block_rows=block_rows,
        Kx=Kx), np.float32)
    got = window_dma.window_block_dma(
        torch.from_numpy(pmap).bfloat16(), torch.from_numpy(rel),
        torch.from_numpy(origins), K=K, H=H, P=P, D=D,
        block_rows=block_rows, Kx=Kx)
    assert got.dtype == torch.bfloat16 and got.shape == (nrows, H * D)
    assert np.abs(got.float().numpy() - want).max() < (
        BF16_CLASS * np.abs(want).max())


@pytest.mark.parametrize("K,Kx", [(8, 8), (16, 16), (6, 8)])
def test_window_dma_plain_equals_block_plain_on_cut_tiles(K, Kx):
    """B5's plain version on a padded map equals B4's on the (K, K) tiles
    cut from the map at the same origins, where every point's stencil keeps
    to the K columns both windows share (float32, 1e-6)."""
    nrows, block_rows, views, hp, wp = 48, 16, 3, 20, 40
    rng = np.random.RandomState(K + Kx)
    rel = np.concatenate([
        rng.uniform(-2.0, K + 1.0, (nrows, H, P)),
        rng.uniform(-2.0, K - 1.0, (nrows, H, P)),
        rng.rand(nrows, H, P)], axis=-1).astype(np.float32)
    rel = torch.from_numpy(rel.reshape(nrows, H * 3 * P))
    nblocks = nrows // block_rows
    pmap = torch.from_numpy(rng.randn(views, hp, wp, H * D).astype(
        np.float32))
    origins = np.stack([rng.randint(0, views, nblocks),
                        rng.randint(0, hp - K + 1, nblocks),
                        8 * rng.randint(0, (wp - Kx) // 8 + 1, nblocks)],
                       -1).astype(np.int32)
    tiles = torch.stack([pmap[v, y0:y0 + K, x0:x0 + K].reshape(K * K, H * D)
                         for v, y0, x0 in origins])
    sizes = dict(K=K, H=H, P=P, D=D, block_rows=block_rows)
    got = window_dma.window_block_dma_plain(
        pmap, rel, torch.from_numpy(origins), Kx=Kx, **sizes)
    want = window_block.window_block_matmul_plain(
        tiles, rel, torch.arange(nblocks, dtype=torch.int32), **sizes)
    assert got.shape == want.shape == (nrows, H * D)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_cpu_calls_launch_no_kernel():
    value, locs, aw, centers_px = make_inputs(0, 3.0)
    for impl in tws.IMPLS:
        plan = tws.build_window_plan(centers_px, SHAPES, tile=4, halo=6,
                                     impl=impl)
        tws.window_sample(torch.from_numpy(value), SHAPES,
                          torch.from_numpy(locs), torch.from_numpy(aw), plan)
    deform_attn.deform_sample(torch.from_numpy(value), SHAPES,
                              torch.from_numpy(locs), torch.from_numpy(aw))
    assert window_block.window_block_matmul.launches == 0
    assert window_dma.window_block_dma.launches == 0
    assert deform_attn.deform_sample.launches == 0


def test_wrappers_refuse_malformed_operands():
    K, nrows, block_rows = 6, 48, 16
    _, rel, bt = _kernel_operands(2, K, K, nrows, block_rows, 3)
    tiles = torch.zeros(3, K * K, H * D)
    rel, bt = torch.from_numpy(rel), torch.from_numpy(bt)
    sizes = dict(K=K, H=H, P=P, D=D, block_rows=block_rows)
    with pytest.raises(ValueError, match="tiles"):
        window_block.window_block_matmul(tiles[:, 1:], rel, bt, **sizes)
    with pytest.raises(ValueError, match="rel"):
        window_block.window_block_matmul(tiles, rel[:, 1:], bt, **sizes)
    with pytest.raises(ValueError, match="whole blocks"):
        window_block.window_block_matmul(tiles, rel[1:], bt, **sizes)
    with pytest.raises(ValueError, match="block_tile"):
        window_block.window_block_matmul(tiles, rel, bt[1:], **sizes)
    pmap = torch.zeros(3, 20, 40, H * D)
    origins = torch.zeros(nrows // block_rows, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="Kx"):
        window_dma.window_block_dma(pmap, rel, origins, Kx=12, **sizes)
    with pytest.raises(ValueError, match="padded_map"):
        window_dma.window_block_dma(pmap[:, :4], rel, origins, Kx=8, **sizes)
    with pytest.raises(ValueError, match="origins"):
        window_dma.window_block_dma(pmap, rel, origins[1:], Kx=8, **sizes)
    with pytest.raises(ValueError, match="unknown window impl"):
        tws.build_window_plan(np.zeros((1, 4, L, 2), np.float32), SHAPES,
                              impl="onehot")
