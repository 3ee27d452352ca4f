"""Steps 8-9 of `DQDecoderLayer`: the plain chain, and the Jacobi DLT as one
hand-written kernel per decoder layer on the card, with a hand-written
backward kernel for training.

The plain chain is two functions, split where a view split all-gathers:
`image_points` (step 8, per view: a stand-in for masked-out points, the
inverse crop affine, the 5-iteration undistortion) and `solve_views` (step
9, across views: the softmax of the logits over the views, the optional
gradient clip, the confidence-weighted DLT, the query mask). `plain_dlt`
is the two with the 'jacobi' solver and `fused_dlt`'s signature: the
kernels' reference. `fused_dlt` launches `csrc/dlt_jacobi.cu` on CUDA
tensors and runs `plain_dlt` on CPU ones. Where `refined` or `logits`
needs a gradient it is an autograd node whose backward launches the
backward kernel: the VJP of the same chain, clip included, recomputed from
the inputs, which are all it keeps. Without a gradient it is the one
forward launch and no node.

`fused_path` is the layer's dispatch rule, from what the call can observe:
the kernel runs where the points are on the card, the solver is 'jacobi'
and every view is on this process, in serving and in training alike. A
view split, the CPU and the other solvers call the two functions of the
plain chain.

`fused_dlt.launches` counts forward launches; `fused_dlt.plain_calls`
counts the CUDA Jacobi calls that `fused_path` sent to the plain chain;
the registry's `dlt_jacobi.backward_launches`
(`utils/profiling.py::COUNTERS`) counts backward launches. Nothing else
changes them.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from mvgformer_tpu_torch.device import constant
from mvgformer_tpu_torch.geometry.cameras import (CameraParams,
                                                  undistort_points)
from mvgformer_tpu_torch.geometry.transforms import apply_affine
from mvgformer_tpu_torch.geometry.triangulate import (clip_cotangent,
                                                      triangulate_dlt)
from mvgformer_tpu_torch.ops import _build
from mvgformer_tpu_torch.utils.profiling import count

_SRC = _build.CSRC / "dlt_jacobi.cu"
# the kernel keeps a point's views in registers: the survey's 3-10 views
MAX_VIEWS = 10


def build() -> Path:
    """Compile the kernel unless the library for this source exists."""
    return _build.build(_SRC)


_LAUNCH = _build.Launcher(
    _SRC, "mvg_dlt_jacobi",
    [ctypes.c_void_p] + [ctypes.c_int64] * 4
    + [ctypes.c_void_p] + [ctypes.c_int64] * 3
    + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_LAUNCH_BWD = _build.Launcher(
    _SRC, "mvg_dlt_jacobi_bwd",
    [ctypes.c_void_p] + [ctypes.c_int64] * 4
    + [ctypes.c_void_p] + [ctypes.c_int64] * 3
    + [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 3
    + [ctypes.c_void_p] * 2 + [ctypes.c_float] + [ctypes.c_int] * 4
    + [ctypes.c_void_p])
BACKWARD_COUNTER = "dlt_jacobi.backward_launches"


def fused_path(device: torch.device, solver: str, split: bool) -> bool:
    """Whether a DQ layer's steps 8-9 on `device` take the kernels: CUDA,
    the 'jacobi' solver and no view split, with or without a gradient. A
    CUDA Jacobi call that takes the plain chain (a view split) counts in
    `fused_dlt.plain_calls`."""
    if device.type != "cuda" or solver != "jacobi":
        return False
    if split:
        fused_dlt.plain_calls += 1
        return False
    return True


def image_points(refined: torch.Tensor, mask: torch.Tensor,
                 stand_in: torch.Tensor, inv_affine: torch.Tensor,
                 cameras: CameraParams) -> torch.Tensor:
    """Step 8: (B, V, N, 2) undistorted image px of the net-image px
    `refined` (V, B, N, 2); where `mask` (B, N) is False, of `stand_in`."""
    tri_in = torch.where(mask[None, :, :, None], refined, stand_in)
    orig = apply_affine(tri_in.transpose(0, 1), inv_affine)
    return undistort_points(orig, cameras, iter_num=5)


def solve_views(points: torch.Tensor, logits: torch.Tensor,
                mask: torch.Tensor, proj: torch.Tensor, solver: str,
                grad_clip: Optional[float] = None) -> torch.Tensor:
    """Step 9: (B, N, 3) points triangulated by `solver` from `points`
    (B, V, N, 2), weighted by the softmax over views of `logits` (V, B, N),
    through `proj` (B, V, 3, 4); zero where `mask` (B, N) is False.
    `grad_clip` bounds the cotangents the solve sends back."""
    B, V, N, _ = points.shape
    pts = points.transpose(1, 2)  # (B, N, V, 2)
    conf = torch.softmax(logits, dim=0).permute(1, 2, 0)  # (B, N, V)
    if grad_clip is not None:
        pts = clip_cotangent(pts, grad_clip)
        conf = clip_cotangent(conf[..., None], grad_clip)[..., 0]
    pm = proj[:, None].expand(B, N, V, 3, 4)
    new_refs = triangulate_dlt(pm, pts, conf, solver=solver)
    return torch.where(mask[..., None], new_refs, 0.0)


def plain_dlt(refined: torch.Tensor, logits: torch.Tensor,
              mask: torch.Tensor, inv_affine: torch.Tensor,
              cameras: CameraParams, proj: torch.Tensor,
              grad_clip: Optional[float] = None) -> torch.Tensor:
    """Steps 8-9 with the 'jacobi' solver, arguments as `fused_dlt`'s.
    Masked-out points stand in at the net image's corner (the layer's at
    its centre): no point reads another's, and they come out as zeros."""
    corner = constant(0.0, refined.dtype, refined.device)
    points = image_points(refined, mask, corner, inv_affine, cameras)
    return solve_views(points, logits, mask, proj, "jacobi", grad_clip)


def _check(refined, logits, mask, inv_affine, cameras, proj):
    if refined.dim() != 4 or refined.shape[-1] != 2:
        raise ValueError("refined must be (V, B, N, 2), got "
                         f"{tuple(refined.shape)}")
    V, B, N, _ = refined.shape
    want = {"logits": (logits, (V, B, N)), "mask": (mask, (B, N)),
            "inv_affine": (inv_affine, (B, V, 2, 3)),
            "f": (cameras.f, (B, V, 2)), "c": (cameras.c, (B, V, 2)),
            "k": (cameras.k, (B, V, 3)), "p": (cameras.p, (B, V, 2)),
            "proj": (proj, (B, V, 3, 4))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} for refined "
                             f"{tuple(refined.shape)}, got {tuple(t.shape)}")
    devices = {t.device for t, _ in want.values()} | {refined.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


def _launch(refined, logits, mask, inv_affine, f, c, k, p, proj):
    B, N = mask.shape
    out = torch.empty((B, N, 3), dtype=torch.float32, device=refined.device)
    if B * N == 0:
        return out
    _LAUNCH(refined, refined.data_ptr(), *refined.stride(),
            logits.data_ptr(), *logits.stride(), mask.data_ptr(),
            inv_affine.data_ptr(), f.data_ptr(), c.data_ptr(), k.data_ptr(),
            p.data_ptr(), proj.data_ptr(), out.data_ptr(), B, N,
            refined.shape[0])
    fused_dlt.launches += 1
    return out


class _FusedDLT(torch.autograd.Function):
    """The forward kernel as an autograd node: it keeps its inputs alone,
    and its backward launches the backward kernel on them."""

    @staticmethod
    def forward(ctx, refined, logits, mask, inv_affine, f, c, k, p, proj,
                grad_clip):
        ctx.save_for_backward(refined, logits, mask, inv_affine, f, c, k, p,
                              proj)
        ctx.grad_clip = grad_clip
        return _launch(refined, logits, mask, inv_affine, f, c, k, p, proj)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        refined, logits, mask, inv_affine, f, c, k, p, proj = \
            ctx.saved_tensors
        V, B, N, _ = refined.shape
        d_refined = torch.empty((V, B, N, 2), dtype=torch.float32,
                                device=refined.device)
        d_logits = torch.empty((V, B, N), dtype=torch.float32,
                               device=refined.device)
        if B * N:
            clip = ctx.grad_clip
            _LAUNCH_BWD(refined, refined.data_ptr(), *refined.stride(),
                        logits.data_ptr(), *logits.stride(),
                        mask.data_ptr(), inv_affine.data_ptr(),
                        f.data_ptr(), c.data_ptr(), k.data_ptr(),
                        p.data_ptr(), proj.data_ptr(), grad.data_ptr(),
                        *grad.stride(), d_refined.data_ptr(),
                        d_logits.data_ptr(),
                        0.0 if clip is None else clip,
                        0 if clip is None else 1, B, N, V)
            count(BACKWARD_COUNTER)
        needs = ctx.needs_input_grad
        return (d_refined if needs[0] else None,
                d_logits if needs[1] else None) + (None,) * 8


def fused_dlt(refined: torch.Tensor, logits: torch.Tensor,
              mask: torch.Tensor, inv_affine: torch.Tensor,
              cameras: CameraParams, proj: torch.Tensor,
              grad_clip: Optional[float] = None) -> torch.Tensor:
    """(B, N, 3) triangulated points, zero where `mask` is False.

    refined (V, B, N, 2) net-image px and logits (V, B, N), float32 at any
    strides; mask (B, N) bool; inv_affine (B, V, 2, 3) net -> full image;
    the cameras' f, c, p (B, V, 2) and k (B, V, 3); proj (B, V, 3, 4):
    float32 and, on CUDA, contiguous. V at most MAX_VIEWS on CUDA. The
    gradient reaches `refined` and `logits` alone: on CUDA no other input
    may require one. `grad_clip` (TRAIN.TRI_GRAD_CLIP) bounds each view's
    point and weight cotangent, as `solve_views`'s.
    """
    _check(refined, logits, mask, inv_affine, cameras, proj)
    if refined.device.type == "cpu":
        return plain_dlt(refined, logits, mask, inv_affine, cameras, proj,
                         grad_clip)
    if refined.device.type != "cuda":
        raise ValueError(f"unsupported device {refined.device}")
    # refined and logits go at their strides, the rest contiguous
    per_view = {"inv_affine": inv_affine, "f": cameras.f, "c": cameras.c,
                "k": cameras.k, "p": cameras.p, "proj": proj}
    for name, t in {"refined": refined, "logits": logits,
                    **per_view}.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    for name, t in {"mask": mask, **per_view}.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if refined.shape[0] > MAX_VIEWS:
        raise ValueError(f"{refined.shape[0]} views: the kernel takes at "
                         f"most {MAX_VIEWS}")
    operands = (refined, logits, mask, inv_affine, cameras.f, cameras.c,
                cameras.k, cameras.p, proj)
    if torch.is_grad_enabled():
        for name, t in per_view.items():
            if t.requires_grad:
                raise ValueError(f"{name} requires grad: the backward "
                                 "kernel sends cotangents to refined and "
                                 "logits alone")
        if refined.requires_grad or logits.requires_grad:
            return _FusedDLT.apply(*operands, grad_clip)
    return _launch(*operands)


fused_dlt.launches = 0
fused_dlt.plain_calls = 0
