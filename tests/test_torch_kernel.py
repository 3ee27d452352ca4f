"""The port's CUDA kernels against their plain PyTorch versions, on the card:

  * deformable sampling at toy shapes: every D, P in {2, 3, 4, 8}, L in
    {1, 2, 3}, float32 and bfloat16, border, far-outside and non-finite
    locations;
  * the two window kernels (window_block, window_dma) at toy shapes, with
    window coordinates inside, at the edge of and outside the window, and at
    the flagship shapes: the level operands of the flagship rig's layer-1
    plan.

This file imports neither jax nor the `rng` fixture of conftest.py, so it
also runs on a machine without JAX:

    python -m pytest tests/test_torch_kernel.py -m gpu --noconftest

Without a CUDA card the tests skip. Tolerance: 1e-4 in float32 (sums in
another order); 2e-2 in bfloat16 against the plain version in float32
(bfloat16 inputs and output rounding).
"""

import os

import numpy as np
import pytest
import torch

from mvgformer_tpu_torch.ops import deform_attn, sampling, window_block
from mvgformer_tpu_torch.ops import window_dma, window_sampling

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
    plan = build_layer1_window_plan(cfg, batch.view_data).to(cuda)
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
