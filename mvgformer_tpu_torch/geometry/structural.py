"""Structural triangulation: bone-length-constrained 3D pose recovery.

Port of `mvgformer_tpu/geometry/structural.py`, the decoder's
`triangulation_method: 'st'`. The confidence-weighted reprojection
quadratic over a person's joints is rewritten in the bone vectors b of a
kinematic tree (G converts bones to joints, D = 2 KR^T M KR is
block-diagonal per joint), which gives A b = beta, 3(J - 1) unknowns;
method 'LS' solves it, 'ST' then renormalizes the bone lengths toward their
targets by `n_steps` step-constraint (SCA) rank updates of A^-1, and
'Lagrangian' takes `n_steps` plain Lagrangian steps instead.

Every person of the batch is solved at once with batched matrix products
and `torch.linalg.inv` (JAX maps the per-person solve with vmap): the 45 x
45 block-diagonal D and the 42 x 42 A per person at 15 joints.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# kinematic trees: (child, parent) bones, the root's joint index, the joint
# count; a copy of the JAX package's table
TREES = {
    "cmupanoptic": {
        "root": 0,
        "bones": [(1, 0), (2, 0), (3, 0), (4, 3), (5, 4), (9, 0), (10, 9),
                  (11, 10), (6, 2), (12, 2), (7, 6), (8, 7), (13, 12),
                  (14, 13)],
        "size": 15,
    },
    "human36m": {
        "root": 0,
        "bones": [(2, 0), (1, 2), (6, 1), (3, 0), (4, 3), (5, 4), (7, 0),
                  (8, 7), (16, 8), (9, 16), (13, 8), (14, 13), (15, 14),
                  (12, 8), (11, 12), (10, 11)],
        "size": 17,
    },
    "totalcapture": {
        "root": 0,
        "bones": [(2, 0), (1, 2), (6, 1), (3, 0), (4, 3), (5, 4), (7, 0),
                  (8, 7), (9, 8), (13, 8), (14, 13), (15, 14), (12, 8),
                  (11, 12), (10, 11)],
        "size": 16,
    },
}


STRUCTURAL_METHODS = ("LS", "ST", "Lagrangian")


class HumanTree:
    """Joint <-> bone conversion matrices of a kinematic tree: conv_J2B
    (3J, 3J) maps stacked joints to [root; bones], conv_B2J inverts it."""

    def __init__(self, data_type: str = "cmupanoptic"):
        spec = TREES[data_type]
        self.size = n = spec["size"]
        self.root = spec["root"]
        parent = {c: p for c, p in spec["bones"]}
        conv = np.zeros((n * 3, n * 3))
        for i in range(n):
            if i == self.root:
                conv[0:3, 3 * i:3 * i + 3] = np.eye(3)
            elif i < self.root:
                p = parent[i]
                conv[3 * i + 3:3 * i + 6, 3 * i:3 * i + 3] = np.eye(3)
                conv[3 * i + 3:3 * i + 6, 3 * p:3 * p + 3] = -np.eye(3)
            else:
                p = parent[i]
                conv[3 * i:3 * i + 3, 3 * i:3 * i + 3] = np.eye(3)
                conv[3 * i:3 * i + 3, 3 * p:3 * p + 3] = -np.eye(3)
        self.conv_J2B = conv
        self.conv_B2J = np.linalg.inv(conv)

    def bone_lengths(self, poses3d: np.ndarray) -> np.ndarray:
        """(F, J, 3) poses -> (F, J - 1) bone lengths."""
        f = poses3d.shape[0]
        bones = (poses3d.reshape(f, -1) @ self.conv_J2B.T)[:, 3:]
        return np.linalg.norm(bones.reshape(f, -1, 3), axis=2)


def _inner_mat(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) reprojection quadratic form of 2D observations."""
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    return torch.stack([
        torch.stack([one, zero, -u], -1),
        torch.stack([zero, one, -v], -1),
        torch.stack([-u, -v, u * u + v * v], -1)], -2)


def _solve(points2d, confidences, lengths, projections, G, n_steps: int,
           method: str) -> torch.Tensor:
    """points2d (P, V, J, 2), confidences (P, V, J), lengths (P, J - 1),
    projections (P, V, 3, 4), G (3J, 3J) bones -> joints; -> (P, J, 3)."""
    P, V, Nj, _ = points2d.shape
    dev, dt = points2d.device, points2d.dtype
    KR = projections[..., :3]    # (P, V, 3, 3)
    KRT = projections[..., 3]    # (P, V, 3)
    M = _inner_mat(points2d[..., 0], points2d[..., 1])
    M = M * confidences[..., None, None]  # (P, V, J, 3, 3)
    # D_i = 2 sum_v KR_v^T M_vi KR_v, m_i = 2 sum_v KR_v^T M_vi (-KRT_v)
    Dblocks = 2.0 * torch.einsum("pvba,pvjbc,pvcd->pjad", KR, M, KR)
    mblocks = 2.0 * torch.einsum("pvba,pvjbc,pvc->pja", KR, M, -KRT)
    eye_j = torch.eye(Nj, dtype=dt, device=dev)
    D = (Dblocks[:, :, :, None, :]
         * eye_j[None, :, None, :, None]).reshape(P, 3 * Nj, 3 * Nj)
    m = mblocks.reshape(P, -1, 1)

    n_b = 3 * Nj - 3
    Irow = torch.eye(3, dtype=dt, device=dev).repeat(1, Nj)  # (3, 3J)
    MrowFull = Irow @ D                    # (P, 3, 3J)
    TrM_inv = torch.linalg.inv(MrowFull @ Irow.T)
    Mrow = MrowFull[:, :, 3:]
    Gbb = G[3:, 3:]
    eye_b = torch.eye(n_b, dtype=dt, device=dev)
    Q = torch.cat([-((TrM_inv @ Mrow) @ Gbb),
                   eye_b.expand(P, n_b, n_b)], dim=1)
    p = torch.cat([-(TrM_inv @ (Irow @ m)),
                   torch.zeros(P, n_b, 1, dtype=dt, device=dev)], dim=1)
    GD = G.T @ D
    GQ = G @ Q
    GDGQ = GD @ GQ
    A = Q.transpose(1, 2) @ GDGQ
    beta = (p.transpose(1, 2) @ GDGQ
            + m.transpose(1, 2) @ GQ).transpose(1, 2)  # (P, 3(J-1), 1)
    A_inv = torch.linalg.inv(A)
    b = A_inv @ beta  # the least-squares bones

    D31 = torch.eye(Nj - 1, dtype=dt, device=dev).repeat_interleave(3, 0)
    if method == "ST":
        Inv = A_inv
        for i in range(n_steps):
            start_len = torch.linalg.norm(b.reshape(P, -1, 3), dim=2,
                                          keepdim=True)  # (P, J-1, 1)
            target_len = (start_len * (n_steps - i - 1)
                          + lengths[..., None]) / (n_steps - i)
            Db = torch.diag_embed(b[..., 0])
            core = D31.T @ (Db @ (Inv @ (Db @ D31)))
            lam = torch.linalg.inv(core) @ (start_len ** 2
                                            - target_len ** 2) / 4.0
            d_lambda = torch.diag_embed(
                (2.0 * lam[..., 0]).repeat_interleave(3, dim=1))
            Inv = (eye_b - Inv @ d_lambda) @ Inv
            b = Inv @ beta
    elif method == "Lagrangian":
        lam = torch.zeros(P, Nj - 1, 1, dtype=dt, device=dev)
        alpha, beta_lr = 2e-9, 0.5
        for _ in range(n_steps):
            Dh = D31.T @ torch.diag_embed(b[..., 0])
            bn = b - alpha * (A @ b - beta + 2 * (Dh.transpose(1, 2) @ lam))
            hk = ((b.reshape(P, -1, 3) ** 2).sum(dim=2, keepdim=True)
                  - lengths[..., None] ** 2)
            lam = lam + beta_lr * hk
            b = bn

    x0 = -(TrM_inv @ (Mrow @ (Gbb @ b) - Irow @ m))
    return (G @ torch.cat([x0, b], dim=1)).reshape(P, Nj, 3)


def structural_triangulate(projections: torch.Tensor,
                           points2d: torch.Tensor,
                           confidences: Optional[torch.Tensor] = None,
                           bone_lengths: Optional[torch.Tensor] = None,
                           n_steps: int = 1, method: str = "ST",
                           data_type: str = "cmupanoptic",
                           conversion: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Batched structural triangulation.

    Args:
        projections:  (B, V, 3, 4).
        points2d:     (B, V, J, 2) undistorted original-image points.
        confidences:  (B, V, J), or None for a uniform 1 / V.
        bone_lengths: (B, J - 1) target lengths in mm; required by 'ST'.
        n_steps:      SCA (or Lagrangian) steps; 1 is plain ST.
        method:       'LS', 'ST' or 'Lagrangian'.
        conversion:   `HumanTree(data_type).conv_B2J` as a (3J, 3J) tensor
                      on the points' device, or None to build it here (a
                      caller that solves every step builds it once).
    Returns:
        (B, J, 3) float32 poses, solved in float32.
    """
    if method not in STRUCTURAL_METHODS:
        raise ValueError(f"unknown structural method {method!r}")
    B, V, Nj, _ = points2d.shape
    dev = points2d.device
    if confidences is None:
        confidences = torch.full((B, V, Nj), 1.0 / V, device=dev)
    if bone_lengths is None:
        if method == "ST":
            # zero targets would drive every bone toward zero length
            raise ValueError(
                "structural_triangulate(method='ST') requires "
                "bone_lengths; pass target lengths or use method='LS'")
        bone_lengths = torch.zeros((B, Nj - 1), device=dev)
    if conversion is None:
        conversion = torch.as_tensor(HumanTree(data_type).conv_B2J,
                                     device=dev)
    G = conversion.to(torch.float32)
    return _solve(points2d.float(), confidences.float(),
                  bone_lengths.float(), projections.float(), G, n_steps,
                  method)
