"""Camera and crop geometry of the plain reference, in float32 (float64
for the null-vector solve).

The CMU Panoptic camera model: x_cam = R (x - T), y = x_cam[:2] /
(x_cam[2] + 1e-5), radial and tangential distortion with the original
repository's quirk (the tangential term 2 * (p1 y + p2 x) scales both axes,
the cross term is [p2, p1] * r^2), pixel = f * y + c. The benchmark's frame
generator draws its people into the images with the same model.
"""

from __future__ import annotations

import numpy as np
import torch


def project_points(x: torch.Tensor, R, T, f, c, k, p) -> torch.Tensor:
    """World points (..., N, 3) -> pixels (..., N, 2); the camera fields
    broadcast over the leading dims (R (..., 3, 3), T (..., 3, 1), f, c,
    p (..., 2), k (..., 3))."""
    d = x - T.transpose(-1, -2)
    xcam = torch.einsum("...ij,...nj->...ni", R, d)
    y = xcam[..., :2] / (xcam[..., 2:3] + 1e-5)
    r2 = (y * y).sum(-1)
    k1, k2, k3 = k[..., 0:1], k[..., 1:2], k[..., 2:3]
    p1, p2 = p[..., 0:1], p[..., 1:2]
    radial = 1.0 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    tan = p1 * y[..., 1] + p2 * y[..., 0]
    y = y * (radial + 2.0 * tan)[..., None] + torch.stack(
        [p2, p1], dim=-1) * r2[..., None]
    return f[..., None, :] * y + c[..., None, :]


def undistort_points(points: torch.Tensor, f, c, k, p,
                     iterations: int = 5) -> torch.Tensor:
    """Pixels (..., N, 2) -> undistorted pixels, OpenCV's fixed-point
    iteration."""
    fx, fy = f[..., 0:1], f[..., 1:2]
    cx, cy = c[..., 0:1], c[..., 1:2]
    k1, k2, k3 = k[..., 0:1], k[..., 1:2], k[..., 2:3]
    p1, p2 = p[..., 0:1], p[..., 1:2]
    x0 = (points[..., 0] - cx) / fx
    y0 = (points[..., 1] - cy) / fy
    x, y = x0, y0
    for _ in range(iterations):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist
    return torch.stack([fx * x + cx, fy * y + cy], dim=-1)


def intrinsics(f, c) -> torch.Tensor:
    """(..., 3, 3) K from focal lengths and principal points."""
    K = torch.zeros(f.shape[:-1] + (3, 3), dtype=f.dtype, device=f.device)
    K[..., 0, 0], K[..., 1, 1] = f[..., 0], f[..., 1]
    K[..., 0, 2], K[..., 1, 2] = c[..., 0], c[..., 1]
    K[..., 2, 2] = 1.0
    return K


def projection_matrices(R, T, f, c) -> torch.Tensor:
    """(..., 3, 4) P = K [R | -R T]."""
    return intrinsics(f, c) @ torch.cat([R, -(R @ T)], dim=-1)


def apply_affine(points: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """(..., N, 2) points through (..., 2, 3) affines."""
    return points @ A[..., :2].transpose(-1, -2) + A[..., None, :, 2]


def crop_affines(image_wh, net_wh):
    """The full-image -> network-image affine of a centred crop with
    padding (the 200-px scale convention, no rotation) and its inverse, as
    (2, 3) float32 arrays, solved from three point pairs in float64; also
    the centre and the scale in 200-px units."""
    w, h = float(image_wh[0]), float(image_wh[1])
    nw, nh = float(net_wh[0]), float(net_wh[1])
    if w / nw < h / nh:
        pad = (h / nh * nw, h)
    else:
        pad = (w, w / nw * nh)
    center = np.array([w / 2.0, h / 2.0])
    scale = np.array(pad) / 200.0
    src_w, src_h = pad
    if src_w >= src_h:
        src_dir, dst_dir = np.array([0.0, -0.5 * src_w]), \
            np.array([0.0, -0.5 * nw])
    else:
        src_dir, dst_dir = np.array([-0.5 * src_h, 0.0]), \
            np.array([-0.5 * nh, 0.0])

    def third(a, b):
        d = a - b
        return b + np.array([-d[1], d[0]])

    dst0 = np.array([nw * 0.5, nh * 0.5])
    src = np.stack([center, center + src_dir,
                    third(center, center + src_dir)])
    dst = np.stack([dst0, dst0 + dst_dir, third(dst0, dst0 + dst_dir)])

    def solve(a, b):
        M = np.concatenate([a, np.ones((3, 1))], axis=1)
        return np.linalg.solve(M, b).T.astype(np.float32)

    return (solve(src, dst), solve(dst, src), center.astype(np.float32),
            scale.astype(np.float32))


def triangulate(proj: torch.Tensor, points: torch.Tensor,
                conf: torch.Tensor) -> torch.Tensor:
    """Confidence-weighted DLT: proj (..., V, 3, 4), undistorted pixels
    (..., V, 2), weights (..., V) -> (..., 3). The null vector of the
    column-equilibrated system comes from a float64 SVD; an all-zero
    system (a point outside every view) gives the origin."""
    A = (proj[..., 2:3, :] * points[..., :, :, None] - proj[..., :2, :])
    A = (A * conf[..., :, None, None]).reshape(
        A.shape[:-3] + (A.shape[-3] * 2, 4)).double()
    degen = A.abs().amax(dim=(-2, -1)) < 1e-10
    scale = A.abs().amax(dim=-2, keepdim=True) + 1e-12
    _, _, vh = torch.linalg.svd(A / scale, full_matrices=False)
    v = vh[..., -1, :] / scale[..., 0, :]
    xyz = (v[..., :3] / v[..., 3:]).float()
    return torch.where(degen[..., None], torch.zeros_like(xyz), xyz)


def norm_to_mm(x: torch.Tensor, size, center) -> torch.Tensor:
    """Normalized [0, 1] capture-space coordinates -> world mm."""
    s = torch.tensor(size, dtype=x.dtype, device=x.device)
    c = torch.tensor(center, dtype=x.dtype, device=x.device)
    return x * s + c - s / 2.0
