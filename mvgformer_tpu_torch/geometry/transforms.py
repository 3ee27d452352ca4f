"""Affine crop transforms (center/scale/200px convention), rot = 0.

Port of `mvgformer_tpu/geometry/transforms.py`. The crop affines are set-up
work on the host: the three-point solve runs in float64 and the result is
returned as float32.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from mvgformer_tpu_torch.device import constant


def affine_from_three_points(src: torch.Tensor,
                             dst: torch.Tensor) -> torch.Tensor:
    """The (..., 2, 3) affine mapping three src points to three dst points
    (cv2.getAffineTransform): solves dst = A @ [src; 1]. src, dst (..., 3, 2).
    """
    ones = torch.ones(src.shape[:-1] + (1,), dtype=src.dtype,
                      device=src.device)
    M = torch.cat([src, ones], dim=-1)  # (..., 3, 3)
    return torch.linalg.solve(M, dst).transpose(-1, -2)


def _triangles(center, scale, output_size: Sequence[float]):
    """src/dst point triangles of the reference's get_affine_transform with
    rot = 0, in float64. center (..., 2); scale (..., 2) in 200px units."""
    center = torch.as_tensor(np.asarray(center), dtype=torch.float64)
    scale = torch.as_tensor(np.asarray(scale), dtype=torch.float64)
    if scale.ndim < center.ndim or scale.shape[-1] != 2:
        scale = scale[..., None].expand(center.shape)
    scale_tmp = scale * 200.0
    src_w, src_h = scale_tmp[..., 0], scale_tmp[..., 1]
    dst_w, dst_h = float(output_size[0]), float(output_size[1])

    wide = (src_w >= src_h)[..., None]
    zeros = torch.zeros_like(src_w)
    src_dir = torch.where(wide, torch.stack([zeros, src_w * -0.5], dim=-1),
                          torch.stack([src_h * -0.5, zeros], dim=-1))
    dst_dir = torch.where(wide,
                          torch.stack([zeros, zeros + dst_w * -0.5], dim=-1),
                          torch.stack([zeros + dst_h * -0.5, zeros], dim=-1))

    def third(a, b):
        d = a - b
        return b + torch.stack([-d[..., 1], d[..., 0]], dim=-1)

    src0 = center
    src1 = center + src_dir
    src2 = third(src0, src1)
    dst0 = torch.tensor([dst_w * 0.5, dst_h * 0.5],
                        dtype=torch.float64).expand(src0.shape)
    dst1 = dst0 + dst_dir
    dst2 = third(dst0, dst1)
    return (torch.stack([src0, src1, src2], dim=-2),
            torch.stack([dst0, dst1, dst2], dim=-2))


def get_affine_transform(center, scale, output_size) -> torch.Tensor:
    """(..., 2, 3) float32 full-image -> network-image affine."""
    src, dst = _triangles(center, scale, output_size)
    return affine_from_three_points(src, dst).float()


def get_affine_transform_inv(center, scale, output_size) -> torch.Tensor:
    """(..., 2, 3) float32 network-image -> full-image affine."""
    src, dst = _triangles(center, scale, output_size)
    return affine_from_three_points(dst, src).float()


def apply_affine(points: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """Apply (..., 2, 3) affine(s) to (..., N, 2) points."""
    ones = torch.ones(points.shape[:-1] + (1,), dtype=points.dtype,
                      device=points.device)
    homo = torch.cat([points, ones], dim=-1)  # (..., N, 3)
    return torch.matmul(homo, trans.transpose(-1, -2))


def get_scale(image_size, resized_size) -> np.ndarray:
    """Padding-aware crop scale in 200px units (host-side helper)."""
    w, h = float(image_size[0]), float(image_size[1])
    w_resized, h_resized = float(resized_size[0]), float(resized_size[1])
    if w / w_resized < h / h_resized:
        w_pad = h / h_resized * w_resized
        h_pad = h
    else:
        w_pad = w
        h_pad = w / w_resized * h_resized
    return np.array([w_pad / 200.0, h_pad / 200.0], dtype=np.float32)


def norm2absolute(coords: torch.Tensor, grid_size,
                  grid_center) -> torch.Tensor:
    """Normalized [0, 1] capture-space coordinates -> world mm."""
    size = constant(grid_size, coords.dtype, coords.device)
    center = constant(grid_center, coords.dtype, coords.device)
    return coords * size + center - size / 2.0
