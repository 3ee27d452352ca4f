"""Batch dataclasses: the tensors one inference or training step takes.

Port of `mvgformer_tpu/data/meta.py`, with dataclasses of tensors in place
of flax struct pytrees. Camera fields are shaped (B, V, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mvgformer_tpu_torch.geometry.cameras import CameraParams
from mvgformer_tpu_torch.geometry.transforms import (
    get_affine_transform,
    get_affine_transform_inv,
    get_scale,
)


def map_tensors(obj, fn):
    """Apply `fn` to every tensor field of a dataclass (recursively)."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    return dataclasses.replace(obj, **{
        f.name: map_tensors(getattr(obj, f.name), fn)
        for f in dataclasses.fields(obj)})


def _to(obj, device):
    """Move every tensor field of a dataclass (recursively) to `device`."""
    return map_tensors(obj, lambda t: t.to(device))


@dataclasses.dataclass
class ViewData:
    """Per-(batch, view) camera and crop information."""

    cameras: CameraParams          # fields shaped (B, V, ...)
    centers: torch.Tensor          # (B, V, 2) full-image centers (w/2, h/2)
    scales: torch.Tensor           # (B, V, 2) crop scales in 200px units
    affine: torch.Tensor           # (B, V, 2, 3) full-image -> net-image
    inv_affine: torch.Tensor       # (B, V, 2, 3) net-image -> full-image
    joints_vis_2d: torch.Tensor    # (B, V, M, J) per-view gt 2D visibility

    @property
    def num_views(self) -> int:
        return self.centers.shape[1]

    def to(self, device) -> "ViewData":
        return _to(self, device)


@dataclasses.dataclass
class Targets:
    """Padded ground truth (M = MAX_PEOPLE_NUM slots)."""

    joints_3d: torch.Tensor       # (B, M, J, 3) world mm
    joints_3d_vis: torch.Tensor   # (B, M, J) visibility in {0, 1}
    roots_3d: torch.Tensor        # (B, M, 3)
    num_person: torch.Tensor      # (B,) int32

    def to(self, device) -> "Targets":
        return _to(self, device)


@dataclasses.dataclass
class Batch:
    """One step's input."""

    views: torch.Tensor           # (B, V, H, W, 3) normalized images (NHWC)
    view_data: ViewData
    targets: Optional[Targets] = None

    def to(self, device) -> "Batch":
        return _to(self, device)


def build_view_data(cameras: CameraParams,
                    image_wh: np.ndarray,
                    net_image_size,
                    joints_vis_2d: Optional[np.ndarray] = None,
                    max_people: int = 10,
                    num_joints: int = 15) -> ViewData:
    """Assemble ViewData from cameras and per-view full-image sizes.

    cameras fields shaped (B, V, ...); image_wh (B, V, 2) full-image (w, h).
    """
    B, V = image_wh.shape[:2]
    centers = image_wh.astype(np.float32) / 2.0
    scales = np.stack([
        np.stack([get_scale(image_wh[b, v], net_image_size)
                  for v in range(V)]) for b in range(B)])
    if joints_vis_2d is None:
        joints_vis_2d = np.ones((B, V, max_people, num_joints),
                                dtype=np.float32)
    return ViewData(
        cameras=cameras,
        centers=torch.from_numpy(centers),
        scales=torch.from_numpy(scales),
        affine=get_affine_transform(centers, scales, net_image_size),
        inv_affine=get_affine_transform_inv(centers, scales, net_image_size),
        joints_vis_2d=torch.as_tensor(joints_vis_2d, dtype=torch.float32),
    )


def pad_targets(joints_3d_list, max_people: int, num_joints: int) -> Targets:
    """Pad a per-sample list of (n_i, J, 3) gt arrays to (B, M, J, 3)."""
    B = len(joints_3d_list)
    joints = np.zeros((B, max_people, num_joints, 3), dtype=np.float32)
    vis = np.zeros((B, max_people, num_joints), dtype=np.float32)
    num = np.zeros((B,), dtype=np.int32)
    for b, j in enumerate(joints_3d_list):
        n = min(len(j), max_people)
        joints[b, :n] = j[:n]
        vis[b, :n] = 1.0
        num[b] = n
    return Targets(
        joints_3d=torch.from_numpy(joints),
        joints_3d_vis=torch.from_numpy(vis),
        roots_3d=torch.from_numpy(joints[:, :, 2].copy()),  # ROOTIDX = 2
        num_person=torch.from_numpy(num),
    )
