"""Synthetic multi-view scenes: a camera ring, posed people, and random
images or gaussian blobs drawn at the projected joints.

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
from mvgformer_tpu_torch.geometry.transforms import apply_affine

# a blob's float32 term exp(-d^2 / 18) is 0 beyond 43 px (d^2 / 18 > 103.3),
# so each blob is evaluated inside a box of this half-width only
BLOB_SIGMA, BLOB_BOX = 3.0, 48
CHANNEL_SCALE = np.array([2.0, 1.0, -1.0], dtype=np.float32)

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


def render_blobs(net_pix: np.ndarray, vis2d: np.ndarray, num_people: int,
                 H: int, W: int) -> np.ndarray:
    """(B, V, H, W, 3) float32 views with a gaussian blob (sigma 3 px) at
    every joint of the first `num_people` slots seen in a view (vis2d > 0),
    the channels scaled by (2, 1, -1). net_pix (B, V, M, J, 2) network-image
    pixels. The arithmetic is the JAX package's full-image loop's (float64
    terms added one by one into a float32 image); each term is evaluated in
    its blob's box only, beyond which it rounds to 0 in float32."""
    B, V, M, J = vis2d.shape
    views = np.zeros((B, V, H, W, 3), dtype=np.float32)
    for b in range(B):
        for v in range(V):
            img = np.zeros((H, W), dtype=np.float32)
            for m in range(min(num_people, M)):
                for j in range(J):
                    if vis2d[b, v, m, j] <= 0:
                        continue
                    px, py = net_pix[b, v, m, j]
                    x0 = max(int(np.floor(px)) - BLOB_BOX, 0)
                    x1 = min(int(np.floor(px)) + BLOB_BOX + 1, W)
                    y0 = max(int(np.floor(py)) - BLOB_BOX, 0)
                    y1 = min(int(np.floor(py)) + BLOB_BOX + 1, H)
                    if x0 >= x1 or y0 >= y1:
                        continue
                    # the full grid's squares, broadcast from a row and a
                    # column: the same float64 values
                    dx2 = (np.arange(x0, x1) - px) ** 2
                    dy2 = (np.arange(y0, y1) - py) ** 2
                    d2 = dx2[None, :] + dy2[:, None]
                    img[y0:y1, x0:x1] += np.exp(-d2 / (2 * BLOB_SIGMA ** 2))
            # x 2, 1, -1 is exact in float32
            views[b, v] = img[..., None] * CHANNEL_SCALE
    return views


def make_batch(cfg, batch_size: int = 1, seed: int = 0,
               num_people: int = 3, image_size=(1920, 1080),
               render: bool = False, cam_seed=None,
               device="cuda") -> Batch:
    """A synthetic Batch at the configured shapes, made in numpy on the
    host and placed on `device`: the card unless the caller asks for the
    CPU (raises without a card). The images are random, or with `render`
    gaussian blobs at the projected joints (`render_blobs`), which a model
    can learn from.

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
    if render:
        net_pix = apply_affine(
            torch.from_numpy(pix.reshape(batch_size, V, M * J, 2)),
            view_data.affine).reshape(batch_size, V, M, J, 2).numpy()
        views = render_blobs(net_pix, vis2d, num_people, H, W)
    else:
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
        roots_3d=t(tg.roots_3d), num_person=t(tg.num_person),
        voxelpose_pred=(None if tg.voxelpose_pred is None
                        else t(tg.voxelpose_pred)))
    return Batch(views=t(batch.views), view_data=view_data, targets=targets)
