"""Synthetic multi-view scenes: a camera ring, posed people, random images.

Port of `mvgformer_tpu/data/synthetic.py`, made in numpy from `seed` with
the same random streams, so the same seed gives the same batch as the JAX
package and the card can be driven without it.
"""

from __future__ import annotations

import numpy as np
import torch

from mvgformer_tpu_torch.data.meta import (Batch, Targets, ViewData,
                                           build_view_data, pad_targets)
from mvgformer_tpu_torch.device import resolve_device
from mvgformer_tpu_torch.geometry.cameras import CameraParams, project_points

# A canonical standing pose in mm, root (mid-hip, index 2) at the origin,
# in the Panoptic 15-joint order.
T_POSE = np.array(
    [
        [0.0, 0.0, 560.0],      # neck
        [0.0, 80.0, 680.0],     # nose
        [0.0, 0.0, 0.0],        # mid-hip (root)
        [170.0, 0.0, 540.0],    # l-shoulder
        [260.0, 0.0, 300.0],    # l-elbow
        [330.0, 0.0, 80.0],     # l-wrist
        [100.0, 0.0, -20.0],    # l-hip
        [110.0, 0.0, -460.0],   # l-knee
        [120.0, 0.0, -870.0],   # l-ankle
        [-170.0, 0.0, 540.0],   # r-shoulder
        [-260.0, 0.0, 300.0],   # r-elbow
        [-330.0, 0.0, 80.0],    # r-wrist
        [-100.0, 0.0, -20.0],   # r-hip
        [-110.0, 0.0, -460.0],  # r-knee
        [-120.0, 0.0, -870.0],  # r-ankle
    ],
    dtype=np.float32,
)


def look_at_rotation(cam_pos: np.ndarray, target: np.ndarray,
                     up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """World->camera rotation with +z looking from cam_pos toward target."""
    fwd = target - cam_pos
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, dtype=np.float64))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd], axis=0).astype(np.float32)


def make_camera_ring(num_views: int,
                     radius_mm: float = 4500.0,
                     height_mm: float = 1200.0,
                     center=(0.0, -500.0, 800.0),
                     image_size=(1920, 1080),
                     focal: float = 1630.0,
                     seed: int = 0) -> CameraParams:
    """A ring of V distorted cameras looking at the space center, as
    (V, ...) float32 tensors."""
    rng = np.random.RandomState(seed)
    center = np.asarray(center, dtype=np.float64)
    Rs, Ts = [], []
    for i in range(num_views):
        ang = 2.0 * np.pi * i / num_views + rng.uniform(-0.1, 0.1)
        pos = center + np.array([
            radius_mm * np.cos(ang),
            radius_mm * np.sin(ang),
            height_mm + rng.uniform(-200, 200),
        ])
        Rs.append(look_at_rotation(pos, center))
        Ts.append(pos.astype(np.float32).reshape(3, 1))
    f = np.tile(np.array([focal, focal], dtype=np.float32),
                (num_views, 1)) * rng.uniform(
        0.95, 1.05, size=(num_views, 1)).astype(np.float32)
    c = np.tile(np.array([image_size[0] / 2.0, image_size[1] / 2.0],
                         dtype=np.float32), (num_views, 1)) + rng.uniform(
        -20, 20, size=(num_views, 2)).astype(np.float32)
    k = np.stack([
        rng.uniform(-0.3, -0.1, num_views),
        rng.uniform(0.05, 0.2, num_views),
        rng.uniform(-0.01, 0.01, num_views),
    ], axis=-1).astype(np.float32)
    p = rng.uniform(-2e-3, 2e-3, size=(num_views, 2)).astype(np.float32)
    return CameraParams(R=torch.from_numpy(np.stack(Rs)),
                        T=torch.from_numpy(np.stack(Ts)),
                        f=torch.from_numpy(f), c=torch.from_numpy(c),
                        k=torch.from_numpy(k), p=torch.from_numpy(p))


def make_people(num_people: int, seed: int = 0,
                space_center=(0.0, -500.0, 800.0),
                spread_mm: float = 2000.0) -> np.ndarray:
    """Random posed people (num_people, 15, 3) world mm."""
    rng = np.random.RandomState(seed)
    center = np.asarray(space_center, dtype=np.float32)
    poses = []
    for _ in range(num_people):
        root = center + np.array([
            rng.uniform(-spread_mm, spread_mm),
            rng.uniform(-spread_mm, spread_mm),
            rng.uniform(-50.0, 50.0) + 100.0,
        ], dtype=np.float32)
        jitter = rng.normal(0, 40.0, size=T_POSE.shape).astype(np.float32)
        ang = rng.uniform(0, 2 * np.pi)
        rot = np.array([
            [np.cos(ang), -np.sin(ang), 0.0],
            [np.sin(ang), np.cos(ang), 0.0],
            [0.0, 0.0, 1.0],
        ], dtype=np.float32)
        poses.append((T_POSE + jitter) @ rot.T + root)
    return np.stack(poses) if poses else np.zeros((0, 15, 3), np.float32)


def make_batch(cfg, batch_size: int = 1, seed: int = 0,
               num_people: int = 3, image_size=(1920, 1080),
               cam_seed=None, device="cuda") -> Batch:
    """A synthetic Batch at the configured shapes with random images, made
    in numpy on the host and placed on `device`: the card unless the caller
    asks for the CPU (raises without a card).

    cam_seed: seed of the camera ring alone (None reuses `seed`); pinning it
    gives every frame one rig, as a capture studio has.
    """
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    V = cfg.DATASET.CAMERA_NUM
    W, H = cfg.NETWORK.IMAGE_SIZE
    J = cfg.DECODER.num_keypoints
    M = cfg.MULTI_PERSON.MAX_PEOPLE_NUM
    center = tuple(cfg.MULTI_PERSON.SPACE_CENTER)

    ring = make_camera_ring(V, image_size=image_size, center=center,
                            seed=seed if cam_seed is None else cam_seed)
    cams = CameraParams(**{
        name: getattr(ring, name)[None].expand(
            (batch_size,) + getattr(ring, name).shape).contiguous()
        for name in ("R", "T", "f", "c", "k", "p")})
    image_wh = np.tile(np.asarray(image_size, np.float32),
                       (batch_size, V, 1))

    people = [make_people(num_people, seed=seed + 7 * b, space_center=center)
              for b in range(batch_size)]
    targets = pad_targets(people, M, J)

    # per-view 2D visibility: projected joint inside the full image
    gt = targets.joints_3d.reshape(batch_size, 1, M * J, 3).expand(
        batch_size, V, M * J, 3)
    pix = project_points(gt, cams).reshape(batch_size, V, M, J, 2).numpy()
    inb = ((pix[..., 0] >= 0) & (pix[..., 0] < image_wh[:, :, None, None, 0])
           & (pix[..., 1] >= 0)
           & (pix[..., 1] < image_wh[:, :, None, None, 1]))
    vis2d = (inb & (targets.joints_3d_vis.numpy()[:, None] > 0)).astype(
        np.float32)

    view_data = build_view_data(cams, image_wh, (W, H), joints_vis_2d=vis2d,
                                max_people=M, num_joints=J)
    views = rng.randn(batch_size, V, H, W, 3).astype(np.float32) * 0.1
    return Batch(views=torch.from_numpy(views), view_data=view_data,
                 targets=targets).to(device)


def batch_from_jax(batch) -> Batch:
    """A JAX-package Batch (flax struct of jax arrays) -> this package's
    Batch on the CPU, through numpy. For the parity tests."""

    def t(x):
        return torch.from_numpy(np.array(x))

    vd, cams, tg = batch.view_data, batch.view_data.cameras, batch.targets
    view_data = ViewData(
        cameras=CameraParams(R=t(cams.R), T=t(cams.T), f=t(cams.f),
                             c=t(cams.c), k=t(cams.k), p=t(cams.p)),
        centers=t(vd.centers), scales=t(vd.scales), affine=t(vd.affine),
        inv_affine=t(vd.inv_affine), joints_vis_2d=t(vd.joints_vis_2d))
    targets = None if tg is None else Targets(
        joints_3d=t(tg.joints_3d), joints_3d_vis=t(tg.joints_3d_vis),
        roots_3d=t(tg.roots_3d), num_person=t(tg.num_person))
    return Batch(views=t(batch.views), view_data=view_data, targets=targets)
