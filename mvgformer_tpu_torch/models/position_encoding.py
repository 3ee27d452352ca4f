"""Positional encodings: sine embeddings, camera rays, 2D coordinate maps.

Port of `mvgformer_tpu/models/position_encoding.py`: the 2D sine
embedding, the crop-composed intrinsics, per-pixel camera ray directions
for ProjAttn's `use_rayconv` mode and normalized 2D coordinates for its
`use_2d_coordconv` mode. Everything is float32 (K^-1 by torch.linalg.inv);
the caller casts the rays to the compute dtype where it concatenates them
to the features.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def position_embedding_sine(h: int, w: int, num_pos_feats: int = 128,
                            temperature: float = 10000.0,
                            normalize: bool = True,
                            scale: float = 2 * math.pi,
                            device="cpu") -> torch.Tensor:
    """(h, w, 2 * num_pos_feats) sine / cosine 2D embedding, y features
    first (no mask)."""
    y = torch.arange(1, h + 1, dtype=torch.float32,
                     device=device)[:, None].expand(h, w)
    x = torch.arange(1, w + 1, dtype=torch.float32,
                     device=device)[None, :].expand(h, w)
    if normalize:
        eps = 1e-6
        y = y / (h + eps) * scale
        x = x / (w + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / num_pos_feats)
    pos_x = x[..., None] / dim_t
    pos_y = y[..., None] / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                        dim=-1).reshape(h, w, -1)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                        dim=-1).reshape(h, w, -1)
    return torch.cat([pos_y, pos_x], dim=-1)


def crop_intrinsics(K: torch.Tensor, affine: torch.Tensor) -> torch.Tensor:
    """The net-image crop affine (..., 2, 3) composed with K (..., 3, 3):
    K_crop = [A; 0 0 1] @ K."""
    bottom = torch.tensor([0.0, 0.0, 1.0], dtype=K.dtype,
                          device=K.device).expand(K.shape[:-2] + (1, 3))
    return torch.cat([affine.to(K.dtype), bottom], dim=-2) @ K


def get_rays(image_size: Tuple[int, int], h: int, w: int,
             K_crop: torch.Tensor, R: torch.Tensor,
             T_standard: torch.Tensor) -> torch.Tensor:
    """Per-pixel unit ray directions in world coordinates, (..., h, w, 3):
    K scaled by the feature map's ratio to the net image, pixel -> camera
    -> world, normalized. T_standard is t with x_cam = R x + t."""
    ratio = w / float(image_size[0])
    K = K_crop.float().clone()
    K[..., :2, :] *= ratio
    R = R.float()
    T = T_standard.float().reshape(T_standard.shape[:-2] + (3, 1))
    jj, ii = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=K.device),
        torch.arange(w, dtype=torch.float32, device=K.device), indexing="ij")
    xy1 = torch.stack([ii, jj, torch.ones_like(ii)], dim=-1).reshape(-1, 3)
    Kinv = torch.linalg.inv(K)
    pixel_cam = xy1 @ Kinv.transpose(-1, -2)  # (..., hw, 3)
    rays_o = -(R.transpose(-1, -2) @ T)  # (..., 3, 1)
    pixel_world = (pixel_cam - T.transpose(-1, -2)) @ R
    rays_d = pixel_world - rays_o.transpose(-1, -2)
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    return rays_d.reshape(rays_d.shape[:-2] + (h, w, 3))


def get_2d_coords(h: int, w: int, device="cpu") -> torch.Tensor:
    """Normalized (h, w, 2) pixel coordinates (x / w, y / h)."""
    jj, ii = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([ii / w, jj / h], dim=-1)
