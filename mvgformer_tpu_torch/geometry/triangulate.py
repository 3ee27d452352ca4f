"""Confidence-weighted DLT triangulation, batched over all points.

Port of `mvgformer_tpu/geometry/triangulate.py`: build per-point
A = conf * (p * P_row3 - P_rows12), take the null-space direction of A and
dehomogenize. Solvers:

    'svd'    -- torch.linalg.svd of A in float64 (the reference's own
                formulation);
    'eigh'   -- eigenvector of the smallest eigenvalue of the column-
                equilibrated 4x4 Gram matrix;
    'jacobi' -- the same Gram matrix solved by a fixed-sweep cyclic Jacobi
                loop written as elementwise tensor math (the flagship
                solver). Plain torch ops here: the CPU and view-split
                path, and the reference of the kernels of
                `ops/dlt_jacobi.py`, which run a decoder layer's whole DLT
                on the card in one launch, and its backward (the VJP of
                these fixed sweeps) in one more.
"""

from __future__ import annotations

from typing import Optional

import torch

from mvgformer_tpu_torch.device import constant

_JACOBI_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def jacobi4_smallest(G: torch.Tensor, sweeps: int = 6) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of symmetric (..., 4, 4) G.

    Fixed-count cyclic Jacobi: the matrix lives as its 10 unique entries and
    the accumulated rotation as 16, each a (...,) tensor.
    """
    a = {(i, j): G[..., i, j].float() for i in range(4) for j in range(i, 4)}
    zero = torch.zeros_like(a[(0, 0)])
    one = torch.ones_like(zero)
    v = {(r, c): (one if r == c else zero) for r in range(4) for c in range(4)}

    def get(i, j):
        return a[(i, j)] if i <= j else a[(j, i)]

    def put(i, j, val):
        a[(i, j) if i <= j else (j, i)] = val

    for _ in range(sweeps):
        for (p, q) in _JACOBI_PAIRS:
            app, aqq, apq = a[(p, p)], a[(q, q)], a[(p, q)]
            # skip rotations whose off-diagonal is negligible relative to
            # the diagonal (with an absolute floor), as the reference does
            small = apq.abs() <= (1e-12 * (app.abs() + aqq.abs()) + 1e-15)
            safe = torch.where(small, one, apq)
            tau = (aqq - app) / (2.0 * safe)
            t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            t = torch.where(tau == 0.0, one, t)  # tau = 0 -> 45 degrees
            t = torch.where(small, zero, t)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            a[(p, p)] = app - t * apq
            a[(q, q)] = aqq + t * apq
            a[(p, q)] = torch.where(small, apq, zero)
            for r in range(4):
                if r == p or r == q:
                    continue
                arp, arq = get(r, p), get(r, q)
                put(r, p, c * arp - s * arq)
                put(r, q, s * arp + c * arq)
            for r in range(4):
                vrp, vrq = v[(r, p)], v[(r, q)]
                v[(r, p)] = c * vrp - s * vrq
                v[(r, q)] = s * vrp + c * vrq

    vals = torch.stack([a[(i, i)] for i in range(4)], dim=-1)
    idx = torch.argmin(vals, dim=-1)
    cols = torch.stack(
        [torch.stack([v[(r, c)] for c in range(4)], dim=-1)
         for r in range(4)], dim=-2)  # (..., row, col)
    idx = idx[..., None, None].expand(cols.shape[:-1] + (1,))
    return torch.gather(cols, -1, idx)[..., 0]


class _ClipCotangent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, max_norm):
        ctx.max_norm = max_norm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        n = torch.linalg.vector_norm(g.float(), dim=-1, keepdim=True)
        scale = torch.clamp(ctx.max_norm / torch.clamp(n, min=1e-30), max=1.0)
        return g * scale.to(g.dtype), None


def clip_cotangent(x: torch.Tensor, max_norm: float) -> torch.Tensor:
    """Identity whose backward clips each last-axis vector's cotangent to
    norm `max_norm` (rescaled, direction kept): TRAIN.TRI_GRAD_CLIP, the
    from-scratch stabilizer for gradients that reach the offset net through
    an ill-conditioned DLT solve. The forward is exact."""
    return _ClipCotangent.apply(x, float(max_norm))


def homogeneous_to_euclidean(points: torch.Tensor) -> torch.Tensor:
    """(..., D+1) -> (..., D)."""
    return points[..., :-1] / points[..., -1:]


def _dlt_system(proj: torch.Tensor, points2d: torch.Tensor,
                confidences: Optional[torch.Tensor]) -> torch.Tensor:
    """A (..., 2V, 4) from proj (..., V, 3, 4) and points (..., V, 2)."""
    row3 = proj[..., 2:3, :]
    rows12 = proj[..., :2, :]
    A = row3 * points2d[..., :, :, None] - rows12  # (..., V, 2, 4)
    if confidences is not None:
        A = A * confidences[..., :, None, None]
    shape = A.shape
    return A.reshape(shape[:-3] + (shape[-3] * 2, 4))


def triangulate_dlt(proj: torch.Tensor, points2d: torch.Tensor,
                    confidences: Optional[torch.Tensor] = None,
                    solver: str = "eigh") -> torch.Tensor:
    """Triangulate (..., 3) points from proj (..., V, 3, 4), pixel points
    (..., V, 2) (original image, undistorted) and per-view weights (..., V).
    """
    A = _dlt_system(proj, points2d, confidences).float()
    # degenerate-system guard: an all-zero A (a query outside every view)
    # has no defined null vector; substitute rows e0, e1/2, e2/4 whose
    # unique null vector is e3 (the origin)
    degen = A.abs().amax(dim=(-2, -1), keepdim=True) < 1e-10
    diag = {0: 1.0, 1: 0.5, 2: 0.25}
    tmpl = constant([[diag[i] if i == j and i in diag else 0.0
                      for j in range(A.shape[-1])]
                     for i in range(A.shape[-2])], A.dtype, A.device)
    A = torch.where(degen, tmpl, A)
    if solver == "svd":
        # float64: a float32 SVD of these ill-conditioned 2V x 4 systems
        # moves points at 3-5 m by a few mm from one LAPACK to another
        _, _, vh = torch.linalg.svd(A.double(), full_matrices=False)
        v = -vh[..., 3, :].float()  # the reference's sign convention
    elif solver in ("jacobi", "eigh"):
        # column equilibration keeps the 4x4 Gram matrix well-conditioned
        # in float32 (raw entries reach ~1e7); the null direction of A D is
        # D^-1 v, undone below
        colscale = A.abs().amax(dim=-2, keepdim=True) + 1e-12
        An = A / colscale
        gram = torch.matmul(An.transpose(-1, -2), An)
        if solver == "jacobi":
            v = jacobi4_smallest(gram)
        else:
            v = torch.linalg.eigh(gram)[1][..., :, 0]
        v = v / colscale[..., 0, :]
    else:
        raise ValueError(f"unknown solver: {solver}")
    return homogeneous_to_euclidean(v)
