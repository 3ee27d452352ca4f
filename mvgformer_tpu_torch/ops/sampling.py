"""Multi-scale deformable sampling: the plain PyTorch version.

Port of the contract of `mvgformer_tpu/ops/sampling.py::deform_sample`
(the same as the original CUDA op `deform_im2col`):

    * sampling locations are normalized per-level [0, 1] (x, y) coordinates;
      pixel coordinates follow F.grid_sample(align_corners=False):
      pix = loc * size - 0.5;
    * bilinear interpolation with zero padding outside the feature map;
    * output[n, q, h, :] = sum over (level, point) of
      w[n, q, h, l, p] * bilinear(value_l[n, :, h, :], loc[n, q, h, l, p]).

`deform_sample` here is the plain version of the Hopper kernel in
`ops/deform_attn.py`: the kernel's wrapper calls it for CPU tensors, and the
tests and the chip smoke compare the kernel with it.

`deform_sample_corner` is the training sampler, the same contract through
padded 4-corner tables: one table per level (`ops/table_build.py`, kernel
B2) and one gather-reduce per level (`ops/table_gather.py`, kernels B3),
both differentiable.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from mvgformer_tpu_torch.ops.table_build import (build_corner_tables,
                                                 padded_width)
from mvgformer_tpu_torch.ops.table_gather import deform_gather_reduce


def flatten_feature_levels(feats: Sequence[torch.Tensor]):
    """Concat per-level (N, C, H, W) maps into (N, sum HW, C) + the static
    ((h, w), ...) shapes."""
    shapes = tuple((int(f.shape[2]), int(f.shape[3])) for f in feats)
    flat = torch.cat([f.reshape(f.shape[0], f.shape[1], -1) for f in feats],
                     dim=-1)
    return flat.transpose(1, 2), shapes


def bilinear_sample(value: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    h: int, w: int) -> torch.Tensor:
    """Bilinear sample with zero padding, weights in float32.

    value: (N, h*w, D) row-major (y-major) flattened map, any float dtype.
    x, y:  (N, S) float32 pixel coordinates (already -0.5 centered).
    Returns (N, S, D) float32.
    """
    N, _, D = value.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    lx, ly = x - x0, y - y0
    # clamp before the cast: NaN and inf must not become wild indices
    x0i = torch.clamp(x0, -2.0, w + 1.0).long()
    y0i = torch.clamp(y0, -2.0, h + 1.0).long()

    def corner(xi, yi, wgt):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        gathered = torch.gather(value, 1, idx[..., None].expand(N, -1, D))
        return gathered.float() * (wgt * inb)[..., None]

    out = corner(x0i, y0i, (1 - lx) * (1 - ly))
    out += corner(x0i + 1, y0i, lx * (1 - ly))
    out += corner(x0i, y0i + 1, (1 - lx) * ly)
    out += corner(x0i + 1, y0i + 1, lx * ly)
    return out


def deform_sample(value: torch.Tensor,
                  spatial_shapes: Sequence[Tuple[int, int]],
                  sampling_locations: torch.Tensor,
                  attention_weights: torch.Tensor) -> torch.Tensor:
    """Fused multi-level deformable sampling, one F.grid_sample per level.

    Args:
        value:              (N, Len_in, H, D); Len_in concatenates every
                            level's h*w (y-major).
        spatial_shapes:     static ((h0, w0), (h1, w1), ...).
        sampling_locations: (N, Lq, H, L, P, 2) in [0, 1], (x, y) order.
        attention_weights:  (N, Lq, H, L, P).

    Returns:
        (N, Lq, H*D) in the dtype of `value`, summed in float32.

    A sample whose bilinear stencil misses the map (including NaN and
    infinite locations) contributes nothing, as in the kernel.
    """
    N, Len_in, H, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    if L != len(spatial_shapes):
        raise ValueError(f"{L} levels in the locations, "
                         f"{len(spatial_shapes)} spatial shapes")
    loc = sampling_locations.float()
    aw = attention_weights.float()
    out = torch.zeros(N * H, D, Lq, dtype=torch.float32, device=value.device)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = value[:, start:start + h * w].float()  # (N, hw, H, D)
        start += h * w
        img = v.permute(0, 2, 3, 1).reshape(N * H, D, h, w)
        lx = loc[:, :, :, lvl, :, 0]  # (N, Lq, H, P)
        ly = loc[:, :, :, lvl, :, 1]
        px, py = lx * w - 0.5, ly * h - 0.5
        touch = (px > -1.0) & (px < w) & (py > -1.0) & (py < h)
        # samples that miss the map are sent far outside it, where
        # grid_sample reads zeros; this also disarms NaN and inf
        grid = torch.stack([torch.where(touch, lx * 2.0 - 1.0, -3.0),
                            torch.where(touch, ly * 2.0 - 1.0, -3.0)], dim=-1)
        grid = grid.permute(0, 2, 1, 3, 4).reshape(N * H, Lq, P, 2)
        sampled = F.grid_sample(img, grid, mode="bilinear",
                                padding_mode="zeros",
                                align_corners=False)  # (N*H, D, Lq, P)
        wgt = aw[:, :, :, lvl].permute(0, 2, 1, 3).reshape(N * H, 1, Lq, P)
        out += (sampled * wgt).sum(dim=-1)
    out = out.reshape(N, H, D, Lq).permute(0, 3, 1, 2).reshape(N, Lq, H * D)
    return out.to(value.dtype)


def deform_sample_corner(value: torch.Tensor,
                         spatial_shapes: Sequence[Tuple[int, int]],
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor) -> torch.Tensor:
    """`deform_sample`'s contract through padded 4-corner tables: port of
    `mvgformer_tpu/ops/sampling.py::deform_sample_corner` with the padded
    stride of its Pallas table build.

    Per level: the sample's top-left pixel (y0, x0) = floor of its pixel
    coordinates picks table row (y0 + 1) * padded_width(w) + x0 + 1,
    clipped into the padded map; its four bilinear weights, zeroed unless
    the stencil touches the map, times the attention weight give w4 in the
    dtype of value. The weights are plain torch, so autograd reaches the
    locations and the attention weights through them; the tables and the
    gather-reduce carry the gradient to value. Differentiable; the result
    (N, Lq, H*D) in the dtype of value, levels summed in float32.

    JAX groups levels into tables under an 8/16 MB operand cap, a TPU
    gather tuning that changes no result; here every level has its own
    table. JAX's `query_chunks` (TRAIN.SAMPLE_CHUNKS) splits its gather
    so the backward does not hold every sample's corner rows; this
    gather-reduce's backward keeps only the tables, indices and weights, so
    the port runs it unchunked (the same result).
    """
    N, Len_in, H, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    if L != len(spatial_shapes):
        raise ValueError(f"{L} levels in the locations, "
                         f"{len(spatial_shapes)} spatial shapes")
    tables, _ = build_corner_tables(value.transpose(1, 2), spatial_shapes)
    acc = None
    for table, (idx, w4) in zip(tables, corner_samples(
            spatial_shapes, sampling_locations, attention_weights,
            value.dtype)):
        red = deform_gather_reduce(table, idx, w4)
        contrib = red.float().reshape(N, H, Lq, P, D).sum(dim=3)
        acc = contrib if acc is None else acc + contrib
    out = acc.transpose(1, 2).reshape(N, Lq, H * D)
    return out.to(value.dtype)


def corner_samples(spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor, dtype: torch.dtype):
    """Per level, the gather-reduce operands of `deform_sample_corner`:
    idx (N*H, Lq*P) int32 table rows and w4 (N*H, Lq*P, 4) corner weights
    times the attention weight, in `dtype`, contiguous; differentiable in
    the locations and weights."""
    N, Lq, H, L, P, _ = sampling_locations.shape
    samples = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        loc = sampling_locations[:, :, :, lvl].float()  # (N, Lq, H, P, 2)
        x = (loc[..., 0] * w - 0.5).transpose(1, 2).reshape(N * H, Lq * P)
        y = (loc[..., 1] * h - 0.5).transpose(1, 2).reshape(N * H, Lq * P)
        x0, y0 = torch.floor(x), torch.floor(y)
        lx, ly = x - x0, y - y0
        touch = (x > -1.0) & (x < w) & (y > -1.0) & (y < h)
        # clamp before the cast: NaN and inf must not become wild indices
        xi = (torch.nan_to_num(x0, nan=0.0).clamp(-1.0, w - 1) + 1).long()
        yi = (torch.nan_to_num(y0, nan=0.0).clamp(-1.0, h - 1) + 1).long()
        idx = (yi * padded_width(w) + xi).int()
        wts = torch.stack([(1 - lx) * (1 - ly), lx * (1 - ly),
                           (1 - lx) * ly, lx * ly], dim=-1)
        aw = attention_weights[:, :, :, lvl].transpose(1, 2).reshape(
            N * H, Lq * P)
        w4 = (wts * touch[..., None] * aw[..., None]).to(dtype)
        samples.append((idx, w4.contiguous()))
    return samples
