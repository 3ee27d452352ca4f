"""Point-top-m in ProjAttn on the card: one hand-written kernel per decoder
layer for the serving selection of each (query, head, level)'s m heaviest
sampling points.

`point_topm` computes what ProjAttn's plain chain computes
(`plain_point_topm`): in each (n, q, h, level) the m largest of the P
softmaxed weights, in descending order with the lower index first among
equal values (a stable descending sort, the rule of jax.lax.top_k), the
locations of the kept points in the same order, and each kept weight
divided by max(the kept weights' sum over (level, point) of its (n, q, h),
1e-6). The slot order matters: the sampler sums over the points in it.

    * CUDA tensors launch `csrc/point_topm.cu` (forward only), or raise.
    * CPU tensors go to `plain_point_topm`.

Serving alone takes this path: training sets point_topm to None
(`models/decoder.py`). The counter `point_topm.launches` of the registry
`utils/profiling.py::COUNTERS` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from mvgformer_tpu_torch.ops import _build
from mvgformer_tpu_torch.utils.profiling import count

_SRC = _build.CSRC / "point_topm.cu"
# the (P, m) pairs the kernel has an instance for: the flagship's
# point-top-4 of 8 points and the AP ablation's point-top-2
INSTANCES = ((8, 4), (8, 2))
COUNTER = "point_topm.launches"


_LAUNCH = _build.Launcher(
    _SRC, "mvg_point_topm",
    [ctypes.c_void_p] * 4 + [ctypes.c_int64] + [ctypes.c_int] * 3
    + [ctypes.c_void_p])


def plain_point_topm(weights: torch.Tensor, locations: torch.Tensor,
                     m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """ProjAttn's plain chain: a stable descending sort of each row's P
    weights, the first m indices, the weights and locations gathered at
    them, and the weights renormalised over (level, point). Arguments as
    `point_topm`'s."""
    idx = torch.sort(weights, dim=-1, descending=True, stable=True)[1][..., :m]
    w_sel = torch.gather(weights, -1, idx)
    kept = w_sel.sum(dim=(-2, -1), keepdim=True)
    w_sel = w_sel / torch.clamp(kept, min=1e-6)
    loc_sel = torch.gather(locations, 4,
                           idx[..., None].expand(idx.shape + (2,)))
    return w_sel, loc_sel


def _check(weights, locations, m):
    if weights.dim() != 5:
        raise ValueError("weights must be (N, Lq, H, Lt, P), got "
                         f"{tuple(weights.shape)}")
    if tuple(locations.shape) != tuple(weights.shape) + (2,):
        raise ValueError(f"locations must be {tuple(weights.shape) + (2,)} "
                         f"for weights {tuple(weights.shape)}, got "
                         f"{tuple(locations.shape)}")
    if not 1 <= m < weights.shape[-1]:
        raise ValueError(f"m must lie in [1, P), got {m} for P "
                         f"{weights.shape[-1]}")
    if weights.device != locations.device:
        raise ValueError(f"inputs on several devices: {weights.device}, "
                         f"{locations.device}")


def point_topm(weights: torch.Tensor, locations: torch.Tensor,
               m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kept weights (N, Lq, H, Lt, m) and locations (N, Lq, H, Lt, m,
    2).

    weights (N, Lq, H, Lt, P), softmaxed over (Lt, P), and locations (N,
    Lq, H, Lt, P, 2); 1 <= m < P. On CUDA both float32, contiguous and
    16-byte aligned, (P, m) one of INSTANCES, and no input may require grad
    (the kernel has no backward).
    """
    _check(weights, locations, m)
    if weights.device.type == "cpu":
        return plain_point_topm(weights, locations, m)
    if weights.device.type != "cuda":
        raise ValueError(f"unsupported device {weights.device}")
    P = weights.shape[-1]
    if (P, m) not in INSTANCES:
        raise ValueError(f"no kernel instance for P {P}, m {m}: the kernel "
                         f"takes (P, m) in {INSTANCES}")
    for name, t in (("weights", weights), ("locations", locations)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if torch.is_grad_enabled() and (weights.requires_grad
                                    or locations.requires_grad):
        raise NotImplementedError(
            "point_topm has no backward kernel; call it under "
            "torch.no_grad() or on tensors that do not require grad")
    N, Lq, H, Lt, _ = weights.shape
    w_out = weights.new_empty((N, Lq, H, Lt, m))
    loc_out = locations.new_empty((N, Lq, H, Lt, m, 2))
    if w_out.numel() == 0:
        return w_out, loc_out
    _LAUNCH(weights, weights.data_ptr(), locations.data_ptr(),
            w_out.data_ptr(), loc_out.data_ptr(), N * Lq * H, Lt, P, m)
    count(COUNTER)
    return w_out, loc_out
