"""Windowed layer-1 sampling straight from the padded feature map: the
Hopper kernel's wrapper and its plain PyTorch version.

`window_block_dma` has the contract of
`mvgformer_tpu/ops/window_dma.py::window_block_dma`: the math of
`ops/window_block.py`, over the (K, Kx) window of padded_map[v] at
(y0, x0), where (v, y0, x0) = origins[b] for the rows of block b. Unlike the
JAX wrapper, origins carry x0 itself and not x0 / 8 (which exists only for
the TPU compiler's alignment proof). The caller aligns x0 down to a multiple
of 8 and widens the window to Kx; rx is relative to the aligned origin.

    * A CPU tensor goes to the plain version, `window_block_dma_plain`.
    * A CUDA tensor launches the hand-written kernel `csrc/window_dma.cu`
      (forward only) or raises. Nothing falls back. Its vector instances (a
      thread per 16-byte vector) run where `_build.vector_width` allows
      them, its generic instance (a thread per element) everywhere else.

Rows come out in the dtype of the map, summed in float32.
`window_block_dma.launches` counts kernel launches; nothing else changes it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mvgformer_tpu_torch.ops import _build
from mvgformer_tpu_torch.ops.window_block import (DTYPE_CODE, apply_rows,
                                                  check_kernel_inputs,
                                                  tent_rows)

_SRC = _build.CSRC / "window_dma.cu"


_FORWARD = _build.Launcher(
    _SRC, "mvg_window_dma_forward",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p])


def window_block_dma_plain(padded_map: torch.Tensor, rel: torch.Tensor,
                           origins: torch.Tensor, K: int, H: int, P: int,
                           D: int, block_rows: int, Kx: int) -> torch.Tensor:
    """The plain version: cut each block's (K, Kx) window out of the map,
    then the weight rows times the window. (nrows, H*D) rows in the dtype
    of the map."""
    o = origins.long()
    ys = o[:, 1:2] + torch.arange(K, device=o.device)   # (nblocks, K)
    xs = o[:, 2:3] + torch.arange(Kx, device=o.device)  # (nblocks, Kx)
    win = padded_map[o[:, 0, None, None], ys[:, :, None], xs[:, None, :]]
    rw = tent_rows(rel, H, P, K, Kx)
    return apply_rows(rw, win.reshape(win.shape[0], K * Kx, H * D),
                      block_rows, H, D).to(padded_map.dtype)


def _check(padded_map, rel, origins, K, H, P, D, block_rows, Kx):
    nrows = rel.shape[0] if rel.dim() == 2 else -1
    if Kx % 8 != 0 or Kx < K:
        raise ValueError(f"Kx = {Kx} must be a multiple of 8 and >= K = {K}")
    if (padded_map.dim() != 4 or padded_map.shape[3] != H * D
            or padded_map.shape[1] < K or padded_map.shape[2] < Kx):
        raise ValueError(f"padded_map must be (V, hp >= {K}, wp >= {Kx}, "
                         f"{H * D}), got {tuple(padded_map.shape)}")
    if rel.dim() != 2 or rel.shape[1] != H * 3 * P:
        raise ValueError(f"rel must be (nrows, {H * 3 * P}), got "
                         f"{tuple(rel.shape)}")
    if nrows % block_rows != 0:
        raise ValueError(f"{nrows} rows are not whole blocks of "
                         f"{block_rows}")
    if tuple(origins.shape) != (nrows // block_rows, 3):
        raise ValueError(f"origins must be ({nrows // block_rows}, 3), got "
                         f"{tuple(origins.shape)}")
    devices = {padded_map.device, rel.device, origins.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


def window_block_dma(padded_map: torch.Tensor, rel: torch.Tensor,
                     origins: torch.Tensor, K: int, H: int, P: int, D: int,
                     block_rows: int, Kx: Optional[int] = None
                     ) -> torch.Tensor:
    """(nrows, H*D) windowed-sampling rows, in tile-sorted row order.

    padded_map (V, hp, wp, H*D) float32 or bfloat16, zero-padded; rel
    (nrows, H*3P) float32; origins (nrows // block_rows, 3) int32 rows of
    (view, y0, x0) in padded pixels; Kx the window width, a multiple of 8
    (default K rounded up to 8). On CUDA all three must be contiguous and
    none may require grad (there is no backward kernel).
    """
    if Kx is None:
        Kx = -(-K // 8) * 8
    _check(padded_map, rel, origins, K, H, P, D, block_rows, Kx)
    if padded_map.device.type == "cpu":
        return window_block_dma_plain(padded_map, rel, origins, K, H, P, D,
                                      block_rows, Kx)
    if padded_map.device.type != "cuda":
        raise ValueError(f"unsupported device {padded_map.device}")
    check_kernel_inputs(padded_map, rel, origins, "origins")
    V, hp, wp, _ = padded_map.shape
    nrows = rel.shape[0]
    out = torch.empty((nrows, H * D), dtype=padded_map.dtype,
                      device=padded_map.device)
    _FORWARD(padded_map, padded_map.data_ptr(), rel.data_ptr(),
             origins.data_ptr(), out.data_ptr(), V, hp, wp, nrows, K, Kx, H,
             P, D, block_rows, DTYPE_CODE[padded_map.dtype],
             _build.vector_width(D, padded_map.element_size(), padded_map,
                                 rel, out))
    window_block_dma.launches += 1
    return out


window_block_dma.launches = 0
