"""Windowed layer-1 sampling over pre-cut tile windows: the Hopper kernel's
wrapper and its plain PyTorch version.

`window_block_matmul` has the contract of
`mvgformer_tpu/ops/window_pallas.py::window_block_matmul`. For row r of block
b = r // block_rows and head h,

    out[r, h*D:(h+1)*D] = sum_{gy, gx < K} rw[r, h, gy, gx]
                          * tiles[block_tile[b], gy*K + gx, h*D:(h+1)*D]
    rw = sum_p aw_p * relu(1 - |ry_p - gy|) * relu(1 - |rx_p - gx|)

with rel[r] packed per head as [ry(P) | rx(P) | aw(P)] in window pixels.

    * A CPU tensor goes to the plain version, `window_block_matmul_plain`,
      which builds the K*K weight rows and multiplies them into the windows.
    * A CUDA tensor launches the hand-written kernel `csrc/window_block.cu`
      (forward only) or raises. Nothing falls back. Its vector instances (a
      thread per 16-byte vector) run where `_build.vector_width` allows
      them, its generic instance (a thread per element) everywhere else.

Rows come out in the dtype of `tiles`, summed in float32 (the TPU kernel
always emits bfloat16). `window_block_matmul.launches` counts kernel
launches; nothing else changes it.
"""

from __future__ import annotations

import ctypes

import torch

from mvgformer_tpu_torch.ops import _build

_SRC = _build.CSRC / "window_block.cu"
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


_FORWARD = _build.Launcher(
    _SRC, "mvg_window_block_forward",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p])


def tent_rows(rel: torch.Tensor, H: int, P: int, K: int, Kw: int,
              row_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(nrows, H*3P) packed rel -> (nrows, H, K*Kw) float32 weight rows over
    a (K, Kw) window, rounded through `row_dtype`."""
    r = rel.float().reshape(-1, H, 3, P)
    ry, rx, aw = r[:, :, 0], r[:, :, 1], r[:, :, 2]  # (nrows, H, P)
    gy = torch.arange(K, dtype=torch.float32, device=rel.device)
    gx = torch.arange(Kw, dtype=torch.float32, device=rel.device)
    wy = torch.relu(1.0 - (ry[..., None] - gy).abs())  # (nrows, H, P, K)
    wx = torch.relu(1.0 - (rx[..., None] - gx).abs())  # (nrows, H, P, Kw)
    rw = torch.einsum("rhpy,rhpx->rhyx", wy * aw[..., None], wx)
    return rw.reshape(rw.shape[0], H, K * Kw).to(row_dtype).float()


def apply_rows(rw: torch.Tensor, windows: torch.Tensor, block_rows: int,
               H: int, D: int) -> torch.Tensor:
    """Weight rows (nrows, H, W) times each block's window (nblocks, W, H*D)
    -> (nrows, H*D) float32."""
    nrows, _, W = rw.shape
    nblocks = nrows // block_rows
    out = torch.einsum("bRhw,bwhd->bRhd",
                       rw.reshape(nblocks, block_rows, H, W),
                       windows.float().reshape(nblocks, W, H, D))
    return out.reshape(nrows, H * D)


def window_block_matmul_plain(tiles: torch.Tensor, rel: torch.Tensor,
                              block_tile: torch.Tensor, K: int, H: int,
                              P: int, D: int, block_rows: int,
                              row_dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """The plain version: (nrows, H*D) rows in the dtype of `tiles`.

    row_dtype rounds the weight rows before the product, as the JAX
    package's blocked einsum does with its `row_dtype`."""
    rw = tent_rows(rel, H, P, K, K, row_dtype)
    return apply_rows(rw, tiles[block_tile.long()], block_rows, H,
                      D).to(tiles.dtype)


def _check(tiles, rel, block_tile, K, H, P, D, block_rows):
    nrows = rel.shape[0] if rel.dim() == 2 else -1
    if tiles.dim() != 3 or tuple(tiles.shape[1:]) != (K * K, H * D):
        raise ValueError(f"tiles must be (n_tiles, {K * K}, {H * D}), got "
                         f"{tuple(tiles.shape)}")
    if rel.dim() != 2 or rel.shape[1] != H * 3 * P:
        raise ValueError(f"rel must be (nrows, {H * 3 * P}), got "
                         f"{tuple(rel.shape)}")
    if nrows % block_rows != 0:
        raise ValueError(f"{nrows} rows are not whole blocks of "
                         f"{block_rows}")
    if tuple(block_tile.shape) != (nrows // block_rows,):
        raise ValueError(f"block_tile must be ({nrows // block_rows},), got "
                         f"{tuple(block_tile.shape)}")
    devices = {tiles.device, rel.device, block_tile.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


def check_kernel_inputs(data: torch.Tensor, rel: torch.Tensor,
                        index: torch.Tensor, index_name: str) -> None:
    """What both window kernels take on CUDA: float32 or bfloat16 data,
    float32 rel, int32 indices, all contiguous, none requiring grad."""
    if any(t.requires_grad for t in (data, rel)):
        raise NotImplementedError(
            "the window kernels have no backward; call them under "
            "torch.no_grad() or on tensors that do not require grad")
    if data.dtype not in DTYPE_CODE:
        raise TypeError(f"window data must be float32 or bfloat16, got "
                        f"{data.dtype}")
    if rel.dtype != torch.float32:
        raise TypeError(f"rel must be float32, got {rel.dtype}")
    if index.dtype != torch.int32:
        raise TypeError(f"{index_name} must be int32, got {index.dtype}")
    for name, t in (("window data", data), ("rel", rel), (index_name, index)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def window_block_matmul(tiles: torch.Tensor, rel: torch.Tensor,
                        block_tile: torch.Tensor, K: int, H: int, P: int,
                        D: int, block_rows: int) -> torch.Tensor:
    """(nrows, H*D) windowed-sampling rows, in tile-sorted row order.

    tiles (n_tiles, K*K, H*D) float32 or bfloat16; rel (nrows, H*3P)
    float32; block_tile (nrows // block_rows,) int32. On CUDA all three must
    be contiguous and none may require grad (there is no backward kernel).
    """
    _check(tiles, rel, block_tile, K, H, P, D, block_rows)
    if tiles.device.type == "cpu":
        return window_block_matmul_plain(tiles, rel, block_tile, K, H, P, D,
                                         block_rows)
    if tiles.device.type != "cuda":
        raise ValueError(f"unsupported device {tiles.device}")
    check_kernel_inputs(tiles, rel, block_tile, "block_tile")
    nrows = rel.shape[0]
    out = torch.empty((nrows, H * D), dtype=tiles.dtype, device=tiles.device)
    _FORWARD(tiles, tiles.data_ptr(), rel.data_ptr(), block_tile.data_ptr(),
             out.data_ptr(), tiles.shape[0], nrows, K, H, P, D, block_rows,
             DTYPE_CODE[tiles.dtype],
             _build.vector_width(D, tiles.element_size(), tiles, rel, out))
    window_block_matmul.launches += 1
    return out


window_block_matmul.launches = 0
