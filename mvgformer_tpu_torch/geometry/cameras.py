"""Camera model: pinhole + radial/tangential distortion, CMU convention.

Port of `mvgformer_tpu/geometry/cameras.py`. Conventions (CMU Panoptic):

    x_cam = R @ (x_world - T)           world -> camera
    y     = x_cam[:2] / (x_cam[2] + 1e-5)
    pixel = f * distort(y) + c

Everything here is float32 and elementwise or tiny 3x3/3x4 products; callers
comparing against the JAX reference turn TF32 off (`device.strict_float32`).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class CameraParams:
    """Batched camera parameters; leading dims are arbitrary (e.g. (B, V))."""

    R: torch.Tensor  # (..., 3, 3) world->camera rotation
    T: torch.Tensor  # (..., 3, 1) camera position in world coords
    f: torch.Tensor  # (..., 2)    focal lengths fx, fy
    c: torch.Tensor  # (..., 2)    principal point cx, cy
    k: torch.Tensor  # (..., 3)    radial distortion k1, k2, k3
    p: torch.Tensor  # (..., 2)    tangential distortion p1, p2

    @property
    def batch_shape(self):
        return self.R.shape[:-2]

    def to(self, device) -> "CameraParams":
        return CameraParams(**{f.name: getattr(self, f.name).to(device)
                               for f in dataclasses.fields(self)})


def _rot_apply(R: torch.Tensor, d: torch.Tensor,
               transpose: bool = False) -> torch.Tensor:
    """Apply a (..., 3, 3) rotation to (..., N, 3) points as nine
    broadcast products, summed in the same order as the reference."""
    cols = [d[..., 0], d[..., 1], d[..., 2]]

    def row(i):
        r = [R[..., j, i, None] if transpose else R[..., i, j, None]
             for j in range(3)]
        return r[0] * cols[0] + r[1] * cols[1] + r[2] * cols[2]

    return torch.stack([row(0), row(1), row(2)], dim=-1)


def world_to_camera(x: torch.Tensor, cam: CameraParams) -> torch.Tensor:
    """(..., N, 3) world points -> camera frame."""
    return _rot_apply(cam.R, x - cam.T.transpose(-1, -2))


def camera_to_world(x: torch.Tensor, cam: CameraParams) -> torch.Tensor:
    """(..., N, 3) camera-frame points -> world."""
    return _rot_apply(cam.R, x, transpose=True) + cam.T.transpose(-1, -2)


def _distort(y: torch.Tensor, cam: CameraParams) -> torch.Tensor:
    """Radial + tangential distortion of normalized coords y (..., N, 2).

    Keeps the reference's quirk: the tangential term `2*tan` multiplies both
    axes and the cross term is [p2, p1] * r2.
    """
    k1, k2, k3 = cam.k[..., 0:1], cam.k[..., 1:2], cam.k[..., 2:3]
    p1, p2 = cam.p[..., 0:1], cam.p[..., 1:2]
    r2 = torch.sum(y * y, dim=-1)  # (..., N)
    radial = 1.0 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    tan = p1 * y[..., 1] + p2 * y[..., 0]
    corr = (radial + 2.0 * tan)[..., None]
    cross = torch.stack([p2, p1], dim=-1) * r2[..., None]
    return y * corr + cross


def project_points(x: torch.Tensor, cam: CameraParams,
                   deal_distortion: bool = True) -> torch.Tensor:
    """Project world points (..., N, 3) to pixels (..., N, 2), with the
    reference's +1e-5 depth epsilon."""
    xcam = world_to_camera(x, cam)
    y = xcam[..., :2] / (xcam[..., 2:3] + 1e-5)
    if deal_distortion:
        y = _distort(y, cam)
    return cam.f[..., None, :] * y + cam.c[..., None, :]


def calib_matrix(cam: CameraParams) -> torch.Tensor:
    """(..., 3, 3) intrinsics K."""
    fx, fy = cam.f[..., 0], cam.f[..., 1]
    cx, cy = cam.c[..., 0], cam.c[..., 1]
    zeros = torch.zeros_like(fx)
    ones = torch.ones_like(fx)
    return torch.stack([
        torch.stack([fx, zeros, cx], dim=-1),
        torch.stack([zeros, fy, cy], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1)], dim=-2)


def projection_matrices(cam: CameraParams,
                        inv_trans: bool = True) -> torch.Tensor:
    """(..., 3, 4) projection matrices P = K [R | T'], with T' = -R @ T in
    the CMU convention (inv_trans=True)."""
    T = -torch.matmul(cam.R, cam.T) if inv_trans else cam.T
    RT = torch.cat([cam.R, T], dim=-1)
    return torch.matmul(calib_matrix(cam), RT)


def undistort_points(points: torch.Tensor, cam: CameraParams,
                     iter_num: int = 5) -> torch.Tensor:
    """Iteratively undistort pixel points (..., N, 2) -> pixel points
    (OpenCV-style fixed-point iteration, `iter_num` steps)."""
    fx, fy = cam.f[..., 0:1], cam.f[..., 1:2]
    cx, cy = cam.c[..., 0:1], cam.c[..., 1:2]
    k1, k2, k3 = cam.k[..., 0:1], cam.k[..., 1:2], cam.k[..., 2:3]
    p1, p2 = cam.p[..., 0:1], cam.p[..., 1:2]

    x0 = (points[..., 0] - cx) / fx
    y0 = (points[..., 1] - cy) / fy
    x, y = x0, y0
    for _ in range(iter_num):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist
    return torch.stack([fx * x + cx, fy * y + cy], dim=-1)
