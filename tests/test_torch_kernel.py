"""The port's CUDA kernels against their plain PyTorch versions, on the card:

  * deformable sampling at toy shapes: every D, P in {2, 3, 4, 8}, L in
    {1, 2, 3}, float32 and bfloat16, border, far-outside and non-finite
    locations; and each of its instances (L 1-4 x P 2, 4, 8 x D 32, 40 and
    6, the last the generic instance; a tensor off 16-byte alignment, which
    takes the generic instance), every case launched twice, bit-identical;
  * the two window kernels (window_block, window_dma) at toy shapes, with
    window coordinates inside, at the edge of and outside the window, and at
    the flagship shapes: the level operands of the flagship rig's layer-1
    plan; the instances of both as deformable sampling's (K 6, 20, 28;
    tile ids out of range and windows off the map included);
  * the corner-table build (B2), bit for bit, from strided level views;
    the table gather-reduce (B3) forward and backward, border rows
    included, on rows as concentrated as the training step's and indices
    off the table, the backward bit-identical over two launches; and the whole corner sampler against the deformable-sampling
    kernel (the same contract) at float32 atol 1e-5;
  * the probe kernels (row gather, windowed gather, take-along, and the
    table slots through B2's kernel) bit for bit, indices off the table
    included, and scale exact over thousands of blocks with a tail, from
    aligned and misaligned pointers; B2 on strided flagship level views
    against its plain version and the table slots' B2 map;
    and the library call timed beside B3 (F.embedding_bag, forward and
    autograd) against B3's plain versions.

This file imports neither jax nor the `rng` fixture of conftest.py, so it
also runs on a machine without JAX:

    python -m pytest tests/test_torch_kernel.py -m gpu --noconftest

Without a CUDA card the tests skip. Tolerance: 1e-4 in float32 (sums in
another order; for the gather-reduce backward 1e-4 of the largest
gradient, its sums over up to hundreds of samples per row running in
sorted order); 2e-2 in bfloat16
against the plain version in float32 (bfloat16 inputs and output
rounding).
"""

import os

import numpy as np
import pytest
import torch

from mvgformer_tpu_torch.ops import _build, deform_attn, sampling
from mvgformer_tpu_torch.ops import table_build, table_gather, window_block
from mvgformer_tpu_torch.ops import window_dma, window_sampling
from mvgformer_tpu_torch.tools.launch_cost import sampling_inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHAPES = ((16, 30), (8, 15), (4, 8))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(seed, N, Lq, H, D, P, shapes):
    rng = np.random.RandomState(seed)
    len_in = sum(h * w for h, w in shapes)
    value = rng.randn(N, len_in, H, D).astype(np.float32)
    locs = rng.uniform(-0.4, 1.4, size=(N, Lq, H, len(shapes), P, 2)
                       ).astype(np.float32)
    for lvl, (h, w) in enumerate(shapes):
        # x in (-1, 0) px, then y in [h-1, h) px
        locs[:, :8, :, lvl, :, 0] = (0.5 - rng.uniform(
            0.01, 0.99, size=locs[:, :8, :, lvl, :, 0].shape)) / w
        locs[:, 8:16, :, lvl, :, 1] = (h - 0.5 + rng.uniform(
            0.0, 0.99, size=locs[:, 8:16, :, lvl, :, 1].shape)) / h
    locs[:, 16, :, :, :, 0] = np.nan
    locs[:, 17, :, :, :, 1] = np.inf
    locs[:, 18, :, :, :, 0] = -np.inf
    locs[:, 19] = 1e20
    w = rng.rand(N, Lq, H, len(shapes), P).astype(np.float32)
    return value, locs, w


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,P,D", [(1, 2, 8), (2, 3, 8), (3, 4, 32),
                                   (3, 8, 32), (3, 4, 40)])
def test_kernel_matches_plain(cuda, dtype, L, P, D):
    shapes = SHAPES[:L]
    value, locs, w = _inputs(L * 100 + P * 10 + D, 3, 50, 4, D, P, shapes)
    v = torch.from_numpy(value).to(cuda, dtype)
    loc = torch.from_numpy(locs).to(cuda)
    aw = torch.from_numpy(w).to(cuda, dtype)
    before = deform_attn.deform_sample.launches
    got = deform_attn.deform_sample(v, shapes, loc, aw)
    torch.cuda.synchronize()
    assert deform_attn.deform_sample.launches == before + 1
    assert got.dtype == dtype and got.shape == (3, 50, 4 * D)
    want = sampling.deform_sample(v.float(), shapes, loc, aw.float())
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    value, locs, w = _inputs(0, 2, 20, 2, 8, 2, SHAPES)
    v = torch.from_numpy(value).to(cuda)
    loc = torch.from_numpy(locs).to(cuda)
    aw = torch.from_numpy(w).to(cuda)
    with pytest.raises(NotImplementedError):
        deform_attn.deform_sample(v.requires_grad_(True), SHAPES, loc, aw)
    v = v.detach()
    with pytest.raises(TypeError):
        deform_attn.deform_sample(v, SHAPES, loc, aw.bfloat16())
    with pytest.raises(TypeError):
        deform_attn.deform_sample(v.half(), SHAPES, loc, aw.half())
    strided = loc.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        deform_attn.deform_sample(v, SHAPES, strided, aw)


def _twice(fn):
    """fn() launched twice: the two results must be the same bits."""
    got, again = fn(), fn()
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    return got


def _vector_width(D, *tensors):
    return _build.vector_width(D, tensors[0].element_size(), *tensors)


def _off_16_bytes(t):
    """A contiguous copy of t whose data starts one element past a 16-byte
    boundary (a view into a larger buffer)."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    shifted = buf[1:1 + t.numel()].view(t.shape)
    shifted.copy_(t)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    return shifted


def _check_deform_sample(value, shapes, loc, aw):
    before = deform_attn.deform_sample.launches
    got = _twice(lambda: deform_attn.deform_sample(value, shapes, loc, aw))
    assert deform_attn.deform_sample.launches == before + 2
    want = sampling.deform_sample(value.float(), shapes, loc, aw.float())
    tol = 1e-4 if value.dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 40, 6])
@pytest.mark.parametrize("P", [2, 4, 8])
@pytest.mark.parametrize("L", [1, 2, 3, 4])
def test_deform_sample_instances(cuda, dtype, L, P, D):
    """Each instance of the kernel: L 3 with P 2, 4, 8 (compile time), the
    run-time instance elsewhere, the generic instance at D 6; on the border,
    far-outside and non-finite locations of launch_cost.sampling_inputs."""
    shapes = (SHAPES + ((2, 3),))[:L]
    gen = torch.Generator(device=cuda).manual_seed(L * 100 + P * 10 + D)
    value, loc, aw = sampling_inputs(64, P, dtype, gen, levels=shapes,
                                     views=2, heads=4, head_dim=D,
                                     device=cuda)
    vector = 16 // value.element_size()
    assert _vector_width(D, value, loc, aw) == (1 if D == 6 else vector)
    _check_deform_sample(value, shapes, loc, aw)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shifted", ["value", "loc", "aw"])
def test_deform_sample_off_16_bytes_takes_the_generic_instance(
        cuda, dtype, shifted):
    gen = torch.Generator(device=cuda).manual_seed(7)
    args = dict(zip(("value", "loc", "aw"), sampling_inputs(
        64, 4, dtype, gen, levels=SHAPES, views=2, heads=4, head_dim=32,
        device=cuda)))
    args[shifted] = _off_16_bytes(args[shifted])
    assert _vector_width(32, *args.values()) == 1
    _check_deform_sample(args["value"], SHAPES, args["loc"], args["aw"])


def _window_operands(seed, K, Kw, nrows, block_rows, n_win, H, P, D):
    """rel with window coordinates inside, at the edge of and outside the
    (K, Kw) window (non-finite ones too), and block indices."""
    rng = np.random.RandomState(seed)
    ry = rng.uniform(-2.0, K + 1.0, (nrows, H, P))
    rx = rng.uniform(-2.0, Kw + 1.0, (nrows, H, P))
    ry[:4], rx[4:8] = -0.5, Kw - 0.5  # the stencil's edge rows / columns
    rx[8, :, 0], ry[9, :, 0] = np.nan, np.inf
    aw = rng.rand(nrows, H, P)
    rel = np.concatenate([ry, rx, aw], -1).astype(np.float32)
    index = rng.randint(0, n_win, nrows // block_rows).astype(np.int32)
    return rng, rel.reshape(nrows, H * 3 * P), index


def _finite_rows(rel):
    """Rows whose window coordinates are all finite: the plain versions
    propagate NaN there, the kernels skip the sample."""
    return np.isfinite(rel).all(axis=1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,H,P,D", [(6, 2, 2, 8), (20, 4, 4, 32),
                                     (28, 8, 4, 32), (28, 2, 8, 40)])
def test_window_block_matches_plain(cuda, dtype, K, H, P, D):
    nrows, block_rows, n_tiles = 96, 32, 5
    rng, rel, bt = _window_operands(K, K, K, nrows, block_rows, n_tiles, H,
                                    P, D)
    tiles = torch.from_numpy(rng.randn(n_tiles, K * K, H * D).astype(
        np.float32)).to(cuda, dtype)
    args = (tiles, torch.from_numpy(rel).to(cuda),
            torch.from_numpy(bt).to(cuda))
    before = window_block.window_block_matmul.launches
    got = window_block.window_block_matmul(*args, K=K, H=H, P=P, D=D,
                                           block_rows=block_rows)
    torch.cuda.synchronize()
    assert window_block.window_block_matmul.launches == before + 1
    assert got.dtype == dtype and got.shape == (nrows, H * D)
    want = window_block.window_block_matmul_plain(
        tiles.float(), *args[1:], K=K, H=H, P=P, D=D, block_rows=block_rows)
    rows = _finite_rows(rel)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy()[rows],
                               want.cpu().numpy()[rows], rtol=tol, atol=tol)
    assert torch.isfinite(got.float()).all()


def _check_window_block(tiles, rel, bt, K, H, P, D, block_rows):
    """window_block against its plain version on the finite rows of the
    blocks whose tile id is in range; the other blocks' rows exactly 0."""
    n_tiles = tiles.shape[0]
    args = (tiles, torch.from_numpy(rel).to(tiles.device),
            torch.from_numpy(bt).to(tiles.device))
    sizes = dict(K=K, H=H, P=P, D=D, block_rows=block_rows)
    before = window_block.window_block_matmul.launches
    got = _twice(lambda: window_block.window_block_matmul(*args, **sizes))
    assert window_block.window_block_matmul.launches == before + 2
    assert got.dtype == tiles.dtype and torch.isfinite(got.float()).all()
    in_range = np.repeat((bt >= 0) & (bt < n_tiles), block_rows)
    want = window_block.window_block_matmul_plain(
        tiles.float(), args[1], args[2].clamp(0, n_tiles - 1), **sizes)
    rows = _finite_rows(rel) & in_range
    tol = 1e-4 if tiles.dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy()[rows],
                               want.cpu().numpy()[rows], rtol=tol, atol=tol)
    assert (got.float().cpu().numpy()[~in_range] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 40, 6])
@pytest.mark.parametrize("P", [2, 4, 8])
@pytest.mark.parametrize("K", [6, 20, 28])
def test_window_block_instances(cuda, dtype, K, P, D):
    """Each instance of the kernel: P 4 and 8 (compile time), the run-time
    instance at P 2, the generic instance at D 6; tile ids -1 and n_tiles
    in two of the four blocks."""
    nrows, block_rows, n_tiles, H = 128, 32, 5, 4
    rng, rel, bt = _window_operands(K * 10 + P + D, K, K, nrows, block_rows,
                                    n_tiles, H, P, D)
    bt[1], bt[3] = n_tiles, -1
    tiles = torch.from_numpy(rng.randn(n_tiles, K * K, H * D).astype(
        np.float32)).to(cuda, dtype)
    vector = 16 // tiles.element_size()
    assert _vector_width(D, tiles, torch.from_numpy(rel)) == (
        1 if D == 6 else vector)
    _check_window_block(tiles, rel, bt, K, H, P, D, block_rows)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_block_off_16_bytes_takes_the_generic_instance(cuda, dtype):
    K, H, P, D, nrows, block_rows, n_tiles = 20, 4, 4, 32, 96, 32, 5
    rng, rel, bt = _window_operands(3, K, K, nrows, block_rows, n_tiles, H,
                                    P, D)
    tiles = _off_16_bytes(torch.from_numpy(rng.randn(
        n_tiles, K * K, H * D).astype(np.float32)).to(cuda, dtype))
    assert _vector_width(D, tiles) == 1
    _check_window_block(tiles, rel, bt, K, H, P, D, block_rows)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,Kx,H,P,D", [(6, 8, 2, 2, 8), (20, 24, 4, 4, 32),
                                        (28, 32, 8, 4, 32),
                                        (28, 32, 2, 8, 40)])
def test_window_dma_matches_plain(cuda, dtype, K, Kx, H, P, D):
    nrows, block_rows, views, hp, wp = 96, 32, 3, K + 9, Kx + 24
    rng, rel, vix = _window_operands(K + 1, K, Kx, nrows, block_rows, views,
                                     H, P, D)
    y0 = rng.randint(0, hp - K + 1, vix.shape)
    x0 = 8 * rng.randint(0, (wp - Kx) // 8 + 1, vix.shape)
    origins = np.stack([vix, y0, x0], -1).astype(np.int32)
    pmap = torch.from_numpy(rng.randn(views, hp, wp, H * D).astype(
        np.float32)).to(cuda, dtype)
    args = (pmap, torch.from_numpy(rel).to(cuda),
            torch.from_numpy(origins).to(cuda))
    before = window_dma.window_block_dma.launches
    got = window_dma.window_block_dma(*args, K=K, H=H, P=P, D=D,
                                      block_rows=block_rows, Kx=Kx)
    torch.cuda.synchronize()
    assert window_dma.window_block_dma.launches == before + 1
    assert got.dtype == dtype and got.shape == (nrows, H * D)
    want = window_dma.window_block_dma_plain(
        pmap.float(), *args[1:], K=K, H=H, P=P, D=D, block_rows=block_rows,
        Kx=Kx)
    rows = _finite_rows(rel)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy()[rows],
                               want.cpu().numpy()[rows], rtol=tol, atol=tol)
    assert torch.isfinite(got.float()).all()


def _check_window_dma(pmap, rel, origins, K, Kx, H, P, D, block_rows):
    """window_dma against its plain version on the finite rows of the
    blocks whose window lies inside the map; the other blocks' rows exactly
    0."""
    V, hp, wp, _ = pmap.shape
    v, y0, x0 = origins.T
    in_map = ((v >= 0) & (v < V) & (y0 >= 0) & (y0 <= hp - K) & (x0 >= 0)
              & (x0 <= wp - Kx))
    args = (pmap, torch.from_numpy(rel).to(pmap.device),
            torch.from_numpy(origins).to(pmap.device))
    sizes = dict(K=K, H=H, P=P, D=D, block_rows=block_rows, Kx=Kx)
    before = window_dma.window_block_dma.launches
    got = _twice(lambda: window_dma.window_block_dma(*args, **sizes))
    assert window_dma.window_block_dma.launches == before + 2
    assert got.dtype == pmap.dtype and torch.isfinite(got.float()).all()
    inside = np.where(in_map[:, None], origins, 0).astype(np.int32)
    want = window_dma.window_block_dma_plain(
        pmap.float(), args[1], torch.from_numpy(inside).to(pmap.device),
        **sizes)
    in_map = np.repeat(in_map, block_rows)
    rows = _finite_rows(rel) & in_map
    tol = 1e-4 if pmap.dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy()[rows],
                               want.cpu().numpy()[rows], rtol=tol, atol=tol)
    assert (got.float().cpu().numpy()[~in_map] == 0).all()


def _window_dma_operands(seed, K, Kx, H, P, D, nrows=192, block_rows=32,
                         views=3):
    """A (views, K + 9, Kx + 24, H*D) map, rel and in-map origins (x0 a
    multiple of 8), as float32 numpy."""
    hp, wp = K + 9, Kx + 24
    rng, rel, vix = _window_operands(seed, K, Kx, nrows, block_rows, views,
                                     H, P, D)
    y0 = rng.randint(0, hp - K + 1, vix.shape)
    x0 = 8 * rng.randint(0, (wp - Kx) // 8 + 1, vix.shape)
    origins = np.stack([vix, y0, x0], -1).astype(np.int32)
    pmap = rng.randn(views, hp, wp, H * D).astype(np.float32)
    return pmap, rel, origins


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 40, 6])
@pytest.mark.parametrize("P", [2, 4, 8])
@pytest.mark.parametrize("K", [6, 20, 28])
def test_window_dma_instances(cuda, dtype, K, P, D):
    """Each instance of the kernel: P 4 and 8 (compile time), the run-time
    instance at P 2, the generic instance at D 6; windows off the map (past
    the bottom, view -1, past the right edge) in three of the six
    blocks."""
    Kx, H = -(-K // 8) * 8, 4
    pmap, rel, origins = _window_dma_operands(K * 10 + P + D, K, Kx, H, P, D)
    V, hp, wp, _ = pmap.shape
    origins[1, 1] = hp - K + 1
    origins[3, 0] = -1
    origins[5, 2] = wp - Kx + 8
    pmap = torch.from_numpy(pmap).to(cuda, dtype)
    vector = 16 // pmap.element_size()
    assert _vector_width(D, pmap, torch.from_numpy(rel)) == (
        1 if D == 6 else vector)
    _check_window_dma(pmap, rel, origins, K, Kx, H, P, D, 32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_dma_off_16_bytes_takes_the_generic_instance(cuda, dtype):
    K, Kx, H, P, D = 20, 24, 4, 4, 32
    pmap, rel, origins = _window_dma_operands(5, K, Kx, H, P, D)
    pmap = _off_16_bytes(torch.from_numpy(pmap).to(cuda, dtype))
    assert _vector_width(D, pmap) == 1
    _check_window_dma(pmap, rel, origins, K, Kx, H, P, D, 32)


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["pallas", "pallas_dma"])
@pytest.mark.parametrize("clamp", [None, 4.0], ids=["K28", "K20"])
def test_window_kernels_match_plain_at_flagship(cuda, impl, clamp):
    """The level operands of the flagship rig's layer-1 plan: 5 views,
    levels 128x240 / 64x120 / 32x60, 8 heads x 32, P 4, bfloat16, offsets
    up to twice the halo."""
    from mvgformer_tpu_torch.config import load_config
    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.models.mvgformer import (
        build_layer1_window_plan, feature_spatial_shapes, layer1_centers_px)

    cfg = load_config(os.path.join(REPO, "configs", "panoptic",
                                   "knn5-lr4-q1024.yaml"))
    cfg.DECODER.layer1_offset_clamp = clamp
    batch = make_batch(cfg, batch_size=1, seed=0, num_people=3)
    plan = build_layer1_window_plan(cfg, batch.view_data)
    centers = torch.from_numpy(layer1_centers_px(cfg, batch.view_data))
    shapes = feature_spatial_shapes(cfg)
    gen = torch.Generator().manual_seed(0)
    V, Lq, L, _ = centers.shape
    H, D, P = 8, 32, 4
    off = (torch.rand(V, Lq, H, L, P, 2, generator=gen) * 4 - 2) * plan.halo
    wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32)
    loc = (centers[:, :, None, :, None, :] + off + 0.5) / wh[:, None, :]
    aw = torch.rand(V, Lq, H, L, P, generator=gen)
    value = torch.randn(V, sum(h * w for h, w in shapes), H, D,
                        generator=gen)
    calls = window_sampling.level_calls(
        value.to(cuda, torch.bfloat16), shapes, loc.to(cuda), aw.to(cuda),
        plan, impl=impl)
    plain = {window_block.window_block_matmul:
             window_block.window_block_matmul_plain,
             window_dma.window_block_dma: window_dma.window_block_dma_plain}
    assert len(calls) == len(shapes)
    for call in calls:
        got = call.fn(*call.args, **call.kwargs)
        want = plain[call.fn](call.args[0].float(), *call.args[1:],
                              **call.kwargs)
        torch.cuda.synchronize()
        assert torch.allclose(got.float(), want, atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [8, 32, 5])
def test_table_build_matches_plain(cuda, dtype, D):
    """Every level of a (N, Len_in, H, D) value, read through the strided
    level view of its transpose (D = 5 takes the 2-byte copy path)."""
    shapes = SHAPES + ((1, 1),)
    value = torch.randn(2, sum(h * w for h, w in shapes), 3, D,
                        generator=torch.Generator().manual_seed(D))
    value = value.to(cuda, dtype)
    sizes = [h * w for h, w in shapes]
    for v, (h, w) in zip(value.transpose(1, 2).split(sizes, dim=2), shapes):
        v = v.unflatten(2, (h, w))
        before = table_build.build_corner_table.launches
        got = table_build.build_corner_table(v)
        torch.cuda.synchronize()
        assert table_build.build_corner_table.launches == before + 1
        want = table_build.build_corner_table_plain(v)
        assert got.dtype == dtype and got.shape == want.shape
        assert torch.equal(got, want)


def _gather_operands(seed, NH, R, S, D, dtype, device, case="uniform"):
    """B3 operands: uniform rows with the border rows 0 and R - 1 mixed in,
    or rows concentrated as in the training step: 'one_row' (every sample
    on one row), 'three_rows' (90% of samples on 3 rows), 'hot' (one row
    holding more samples than the backward's tile), 'off_table' (a fifth of
    the indices outside [0, R))."""
    gen = torch.Generator().manual_seed(seed)
    tables = torch.randn(NH, R, 4 * D, generator=gen)
    idx = torch.randint(0, R, (NH, S), generator=gen, dtype=torch.int32)
    idx[:, ::7] = 0
    idx[:, 1::7] = R - 1
    pick = torch.rand(NH, S, generator=gen)
    if case == "one_row":
        idx[:] = R // 2
    elif case == "three_rows":
        three = torch.tensor([3, R // 2, R - 2], dtype=torch.int32)
        idx = torch.where(pick < 0.9, three[torch.randint(
            0, 3, (NH, S), generator=gen)], idx)
    elif case == "hot":
        idx[:, :3 * table_gather.CHUNK + 5] = 5
    elif case == "off_table":
        idx = torch.where(pick < 0.1, -3, torch.where(pick < 0.2, R + 1, idx))
    w4 = torch.randn(NH, S, 4, generator=gen)
    w4[:, ::5, 1:] = 0.0  # corners outside the map carry weight 0
    ct = torch.randn(NH, S, D, generator=gen)
    return [t.to(device, dtype) if t.is_floating_point() else t.to(device)
            for t in (tables, idx, w4, ct)]


def _check_table_gather(tables, idx, w4, ct):
    """B3 forward and backward against the plain versions (float32: 1e-5,
    backward 1e-4 of the largest gradient; bfloat16: 2e-2), one launch each
    counted, the backward bit-identical over two launches and 0 on the rows
    that no sample touches."""
    dtype = tables.dtype
    before = (table_gather.gather_reduce_forward.launches,
              table_gather.gather_reduce_backward.launches)
    out = table_gather.gather_reduce_forward(tables, idx, w4)
    g_tables, g_w4 = table_gather.gather_reduce_backward(tables, idx, w4, ct)
    torch.cuda.synchronize()
    assert (table_gather.gather_reduce_forward.launches,
            table_gather.gather_reduce_backward.launches) == (
        before[0] + 1, before[1] + 1)
    assert out.dtype == g_tables.dtype == g_w4.dtype == dtype
    again = table_gather.gather_reduce_backward(tables, idx, w4, ct)
    assert torch.equal(again[0], g_tables) and torch.equal(again[1], g_w4)
    f32 = [t.float() if t.is_floating_point() else t
           for t in (tables, idx, w4, ct)]
    want = table_gather.deform_gather_reduce_plain(*f32[:3])
    want_t, want_w = table_gather.gather_reduce_backward_plain(*f32)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert torch.allclose(out.float(), want, atol=tol, rtol=tol)
    for got, ref in ((g_tables, want_t), (g_w4, want_w)):
        scale = ref.abs().max().item()
        if dtype == torch.float32:
            assert (got - ref).abs().max().item() <= 1e-4 * scale
        else:
            assert torch.allclose(got.float(), ref, atol=2e-2 * scale,
                                  rtol=2e-2)
    NH, R, _ = tables.shape
    k = idx.long()
    on = (k >= 0) & (k < R)
    touched = torch.zeros(NH * R, dtype=torch.bool, device=idx.device)
    touched[(torch.arange(NH, device=idx.device)[:, None] * R + k)[on]] = True
    assert (g_tables.reshape(NH * R, -1)[~touched] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [8, 32, 40])
def test_table_gather_matches_plain(cuda, dtype, D):
    _check_table_gather(*_gather_operands(D, 3, 300, 1000, D, dtype, cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 6])
@pytest.mark.parametrize("case", ["one_row", "three_rows", "hot",
                                  "off_table"])
def test_table_gather_concentrated_rows(cuda, dtype, D, case):
    """Rows as concentrated as the training step's, S no multiple of the
    backward's tile; D = 6 takes the scalar forward and the generic
    backward."""
    S = 5 * table_gather.CHUNK + 37
    _check_table_gather(*_gather_operands(D, 3, 300, S, D, dtype, cuda,
                                          case))


@pytest.mark.gpu
def test_table_gather_backward_refuses_wrong_segments(cuda):
    tables, idx, w4, ct = _gather_operands(0, 2, 50, 100, 8, torch.float32,
                                           cuda)
    good = table_gather.row_segments(idx, 50)
    for bad in (good._replace(perm=good.perm.int()),
                good._replace(keys=good.keys[:-1]),
                good._replace(offsets=good.offsets.cpu())):
        with pytest.raises(ValueError, match="segments"):
            table_gather.gather_reduce_backward(tables, idx, w4, ct,
                                                segments=bad)
    got = table_gather.gather_reduce_backward(tables, idx, w4, ct,
                                              segments=good)
    want = table_gather.gather_reduce_backward(tables, idx, w4, ct)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
def test_row_segments_on_the_card_match_the_cpu(cuda):
    idx = _gather_operands(0, 4, 300, 2000, 8, torch.float32, "cpu",
                           "off_table")[1]
    got = table_gather.row_segments(idx.to(cuda), 300)
    want = table_gather.row_segments(idx, 300)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
def test_table_gather_autograd_uses_the_kernels(cuda):
    tables, idx, w4, ct = _gather_operands(1, 2, 64, 256, 8, torch.float32,
                                           cuda)
    tables.requires_grad_(True)
    w4.requires_grad_(True)
    before = table_gather.gather_reduce_backward.launches
    table_gather.deform_gather_reduce(tables, idx, w4).backward(ct)
    torch.cuda.synchronize()
    assert table_gather.gather_reduce_backward.launches == before + 1
    want_t, want_w = table_gather.gather_reduce_backward_plain(
        tables.detach(), idx, w4.detach(), ct)
    assert torch.allclose(tables.grad, want_t, atol=1e-5)
    assert torch.allclose(w4.grad, want_w, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("P", [2, 8])
def test_corner_sampler_matches_deform_kernel(cuda, P):
    """deform_sample_corner (B2 + B3) against deform_sample (B1) on the
    same finite inputs, border and far-outside locations included."""
    value, locs, w = _inputs(P, 3, 50, 4, 8, P, SHAPES)
    locs = np.where(np.isfinite(locs) & (np.abs(locs) < 1e3), locs, 5.0)
    v = torch.from_numpy(value).to(cuda)
    loc = torch.from_numpy(locs.astype(np.float32)).to(cuda)
    aw = torch.from_numpy(w).to(cuda)
    got = sampling.deform_sample_corner(v, SHAPES, loc, aw)
    want = deform_attn.deform_sample(v, SHAPES, loc, aw)
    torch.cuda.synchronize()
    assert torch.allclose(got, want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the probe kernels (csrc/gather_forms.cu): bit for bit against their plain
# versions; scale exact in float32 and, at a = 2, in bfloat16
# ---------------------------------------------------------------------------


def _launched_once(kernel, fn):
    before = kernel.launches
    out = fn()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,R,S,C", [(1, 2048, 512, 128), (3, 300, 1000, 128),
                                     (2, 50, 77, 4), (2, 40, 33, 1040)])
def test_row_gather_matches_plain(cuda, dtype, P, R, S, C):
    from mvgformer_tpu_torch.ops import gather_forms
    gen = torch.Generator().manual_seed(P * R)
    tbl = torch.randn(P, R, C, generator=gen).to(cuda, dtype)
    idx = torch.randint(0, R, (P, S), generator=gen, dtype=torch.int32)
    idx[:, ::11] = R  # off the table: a zero row
    idx = idx.to(cuda)
    got = _launched_once(gather_forms.row_gather,
                         lambda: gather_forms.row_gather(tbl, idx))
    assert torch.equal(got, gather_forms.row_gather_plain(tbl, idx))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["select", "copy", "zero"])
@pytest.mark.parametrize("unit", [8, 1])
def test_window_gather_matches_plain(cuda, dtype, mode, unit):
    from mvgformer_tpu_torch.ops import gather_forms
    P, R, C, nblk, BS, W = 3, 700, 128, 5, 64, 96
    gen = torch.Generator().manual_seed(unit)
    tbl = torch.randn(P, R, C, generator=gen).to(cuda, dtype)
    base = torch.randint(0, (R - W) // unit + 2, (P, nblk), generator=gen,
                         dtype=torch.int32).to(cuda)  # some windows overrun R
    local = torch.randint(-3, W + 3, (P, nblk * BS), generator=gen,
                          dtype=torch.int32).to(cuda)
    got = _launched_once(gather_forms.window_gather,
                         lambda: gather_forms.window_gather(
                             tbl, base, local, W, unit, mode))
    assert torch.equal(got, gather_forms.window_gather_plain(
        tbl, base, local, W, unit, mode))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis,tbl_shape,idx_shape", [
    (0, (2048, 128), (512, 128)), (0, (8, 128), (8, 128)),
    (1, (128, 128), (128, 128)), (0, (31, 7), (300, 7)),
    (1, (300, 9), (300, 5))])
def test_take_along_matches_plain(cuda, dtype, axis, tbl_shape, idx_shape):
    from mvgformer_tpu_torch.ops import gather_forms
    gen = torch.Generator().manual_seed(7)
    tbl = torch.randn(*tbl_shape, generator=gen).to(cuda, dtype)
    n = tbl_shape[axis]
    idx = torch.randint(-1, n + 1, idx_shape, generator=gen,
                        dtype=torch.int32).to(cuda)
    got = _launched_once(gather_forms.take_along,
                         lambda: gather_forms.take_along(tbl, idx, axis))
    assert torch.equal(got, gather_forms.take_along_plain(tbl, idx, axis))


# 6,337 blocks of 256 units in bfloat16 (vectors of 8 elements), the last
# partly filled, and a 3-element tail
SCALE_LARGE = 12_976_931


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2048 * 128, 1001, 7, SCALE_LARGE])
def test_scale_matches_plain(cuda, dtype, n):
    """Exact against the plain version: from a pointer off 16 bytes (every
    element through the tail's path) and from an aligned one (vectors and
    a tail of n % (16 / esize) elements)."""
    from mvgformer_tpu_torch.ops import gather_forms
    full = torch.randn(n + 1, generator=torch.Generator().manual_seed(n))
    full = full.to(cuda, dtype)
    for x in (full[1:], full[:n]):  # off 16 bytes, then aligned
        for a in (2.0, 0.3):
            got = _launched_once(gather_forms.scale,
                                 lambda: gather_forms.scale(x, a))
            want = gather_forms.scale_plain(x, a)
            assert torch.equal(got, want)
            if a == 2.0:
                assert torch.equal(got, x * 2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,D", [(16, 30, 32), (128, 240, 32), (5, 3, 5),
                                   (1, 1, 8)])
def test_table_slots_match_plain_and_b2(cuda, dtype, h, w, D):
    """Every slot map through B2's kernel, bit for bit; the count is the
    table slots' own, B2's stays as it was."""
    from mvgformer_tpu_torch.ops import gather_forms
    v = torch.randn(3, h, w, D, generator=torch.Generator().manual_seed(h))
    v = v.to(cuda, dtype)
    b2_before = table_build.build_corner_table.launches
    for name, slots in gather_forms.SLOT_MAPS.items():
        got = _launched_once(gather_forms.table_slots,
                             lambda: gather_forms.table_slots(v, slots))
        assert torch.equal(got, gather_forms.table_slots_plain(v, slots)), \
            name
    assert table_build.build_corner_table.launches == b2_before
    b2 = table_build.build_corner_table(v[:, None])
    assert torch.equal(gather_forms.table_slots(v, gather_forms.B2_SLOTS),
                       b2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b2_from_strided_value_equals_plain_and_slots(cuda, dtype):
    """B2 on the strided level views of a (N, Len_in, H, D) value, as the
    corner sampler hands them over, at the flagship levels: bit for bit
    against its plain version and against the table slots' B2 map on a
    contiguous copy of each view."""
    from mvgformer_tpu_torch.ops import gather_forms
    from mvgformer_tpu_torch.tools.launch_cost import (FLAGSHIP_LEVELS,
                                                       level_views)
    value = torch.randn(2, sum(h * w for h, w in FLAGSHIP_LEVELS), 3, 32,
                        generator=torch.Generator().manual_seed(5))
    value = value.to(cuda, dtype)
    for v in level_views(value, FLAGSHIP_LEVELS):
        assert not v.is_contiguous()
        got = _launched_once(table_build.build_corner_table,
                             lambda: table_build.build_corner_table(v))
        assert torch.equal(got, table_build.build_corner_table_plain(v))
        flat = v.flatten(0, 1).contiguous()
        assert torch.equal(got, gather_forms.table_slots(
            flat, gather_forms.B2_SLOTS))


@pytest.mark.gpu
def test_gather_forms_refuse_what_they_do_not_take(cuda):
    from mvgformer_tpu_torch.ops import gather_forms
    tbl = torch.zeros(2, 10, 8, device=cuda)
    idx = torch.zeros(2, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        gather_forms.row_gather(tbl.half(), idx)
    with pytest.raises(TypeError):
        gather_forms.row_gather(tbl, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        gather_forms.row_gather(tbl.transpose(1, 2).contiguous().transpose(
            1, 2), idx)
    with pytest.raises(ValueError, match="devices"):
        gather_forms.row_gather(tbl, idx.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_yardstick_is_b3(cuda, dtype):
    """The library call timed beside B3 computes B3's function: forward,
    and in float32 through its autograd the backward, against the plain
    versions. (PyTorch's CUDA embedding_bag has no bfloat16 backward for
    per-sample weights.)"""
    from mvgformer_tpu_torch.utils import yardsticks
    tables, idx, w4, ct = _gather_operands(3, 3, 300, 1000, 32, dtype, cuda)
    weight, rows, offsets, psw = yardsticks.embedding_bag_operands(
        tables, idx, w4)
    weight = weight.detach().requires_grad_(True)
    psw = psw.detach().requires_grad_(True)
    out = yardsticks.embedding_bag_reduce(weight, rows, offsets, psw, 3)
    f32 = [t.float() if t.is_floating_point() else t
           for t in (tables, idx, w4, ct)]
    want = table_gather.deform_gather_reduce_plain(*f32[:3])
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert torch.allclose(out.float(), want, atol=tol, rtol=tol)
    if dtype != torch.float32:
        return
    g_weight, g_psw = torch.autograd.grad(out, (weight, psw), ct)
    want_t, want_w = table_gather.gather_reduce_backward_plain(*f32)
    for got, ref in ((g_weight.reshape(want_t.shape), want_t),
                     (g_psw.reshape(want_w.shape), want_w)):
        scale = ref.abs().max().item()
        assert (got - ref).abs().max().item() <= 1e-4 * scale
