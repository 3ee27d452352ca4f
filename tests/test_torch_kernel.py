"""The deformable-sampling CUDA kernel against its plain PyTorch version, on
the card, at toy shapes: every D, P in {2, 3, 4, 8}, L in {1, 2, 3}, float32
and bfloat16, border, far-outside and non-finite locations.

This file imports neither jax nor the `rng` fixture of conftest.py, so it
also runs on a machine without JAX:

    python -m pytest tests/test_torch_kernel.py -m gpu --noconftest

Without a CUDA card the tests skip. Tolerance: 1e-4 in float32 (sums in
another order); 2e-2 in bfloat16 against the plain version in float32
(bfloat16 inputs and output rounding).
"""

import numpy as np
import pytest
import torch

from mvgformer_tpu_torch.ops import deform_attn
from mvgformer_tpu_torch.ops import sampling

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
