"""Padded 4-corner tables of the feature levels: the Hopper kernel B2's
wrapper, its plain PyTorch version and the autograd function around both.

Port of `mvgformer_tpu/ops/table_pallas.py`. For a level of size (h, w),
the table of (view, head) pair p has (h + 2) * padded_width(w) rows; row
(y, x) is

    [v[y-1, x-1] | v[y-1, x] | v[y, x-1] | v[y, x]]     (4 * D channels)

with zeros outside the map and in the columns past w + 1. A bilinear
sample whose top-left pixel is (y0, x0) reads the one row
(y0 + 1) * padded_width(w) + x0 + 1 (ops/sampling.py::deform_sample_corner).
The same kernel takes slot codes (`launch_table`): slot c of row (y, x)
then holds v[y - 1 + code // 2, x - code % 2], or zeros for the code -1;
B2's table is B2_CODES, and the probe's store patterns
(ops/gather_forms.py::table_slots) are the others.

    * `build_corner_table` is the kernel's wrapper: a CPU tensor goes to
      `build_corner_table_plain`, a CUDA tensor launches
      `csrc/table_build.cu` or raises. `build_corner_table.launches` counts
      kernel launches; nothing else changes it.
    * The build is linear; its backward is the four shifted slice-adds of
      `_vjp_bwd` in plain torch, as in JAX, where it is plain XLA.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from mvgformer_tpu_torch.ops import _build

_SRC = _build.CSRC / "table_build.cu"


def padded_width(w: int) -> int:
    """The row stride of a level of width w: round_up(w + 2, 16)."""
    return ((w + 2 + 15) // 16) * 16


_BUILD = _build.Launcher(
    _SRC, "mvg_table_build",
    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 4
    + [ctypes.c_int] * 4 + [ctypes.c_void_p])
# slot c of B2's row (y, x) holds v[y - 1 + c // 2, x - 1 + c % 2]: the
# code 2 * row + shift of slot c is (row c // 2, shift 1 - c % 2); the C
# side runs its compile-time B2 instance for exactly these codes
B2_CODES = (1, 0, 3, 2)


def build_corner_table_plain(v: torch.Tensor) -> torch.Tensor:
    """(N, H, h, w, D) -> (N*H, (h+2) * padded_width(w), 4D), with pads and
    slices."""
    N, H, h, w, D = v.shape
    wpp = padded_width(w)
    # p[y + 1, x + 1] = v[y, x]; rows 0, h+1, h+2 and the columns past w
    # are zero
    p = F.pad(v, (0, 0, 1, wpp - w, 1, 2))  # (N, H, h+3, wpp+1, D)
    corners = (p[:, :, 0:h + 2, 0:wpp], p[:, :, 0:h + 2, 1:wpp + 1],
               p[:, :, 1:h + 3, 0:wpp], p[:, :, 1:h + 3, 1:wpp + 1])
    return torch.cat(corners, dim=-1).reshape(N * H, (h + 2) * wpp, 4 * D)


def launch_table(v: torch.Tensor, codes: Sequence[int]) -> torch.Tensor:
    """One launch of `csrc/table_build.cu` on the (N, H, h, w, D) CUDA view
    v (unit channel stride, float32 or bfloat16; the caller checks) with
    the 4 slot codes `codes`: the (N*H, (h+2) * padded_width(w), 4D)
    table. Counts nothing: each caller counts its own launches."""
    N, H, h, w, D = v.shape
    wpp = padded_width(w)
    out = torch.empty((N * H, (h + 2) * wpp, 4 * D), dtype=v.dtype,
                      device=v.device)
    _BUILD(v, v.data_ptr(), out.data_ptr(), N, H, h, w, wpp, D,
           v.element_size(), *v.stride()[:4], *codes)
    return out


def build_corner_table(v: torch.Tensor) -> torch.Tensor:
    """(N, H, h, w, D) level view -> (N*H, (h+2) * padded_width(w), 4D)
    table in the dtype of v.

    On CUDA v may be any strided view with unit channel stride (the level
    slice of the (N, Len_in, H, D) value, transposed, without a copy);
    float32 or bfloat16. No autograd: see `corner_table`."""
    if v.dim() != 5:
        raise ValueError(f"v must be (N, H, h, w, D), got {tuple(v.shape)}")
    if v.device.type == "cpu":
        return build_corner_table_plain(v)
    if v.device.type != "cuda":
        raise ValueError(f"unsupported device {v.device}")
    if v.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"v must be float32 or bfloat16, got {v.dtype}")
    if v.stride(-1) != 1:
        raise ValueError("v must have unit channel stride")
    out = launch_table(v, B2_CODES)
    build_corner_table.launches += 1
    return out


build_corner_table.launches = 0


def corner_table_grad(ct: torch.Tensor,
                      shape: Tuple[int, ...]) -> torch.Tensor:
    """The transpose of the build: (N*H, rows, 4D) cotangent -> (N, H, h,
    w, D), the four shifted slice-adds of JAX's `_vjp_bwd`."""
    N, H, h, w, D = shape
    ct = ct.reshape(N, H, h + 2, padded_width(w), 4 * D)
    return (ct[:, :, 1:h + 1, 1:w + 1, 0:D]
            + ct[:, :, 1:h + 1, 0:w, D:2 * D]
            + ct[:, :, 0:h, 1:w + 1, 2 * D:3 * D]
            + ct[:, :, 0:h, 0:w, 3 * D:4 * D])


class CornerTable(torch.autograd.Function):
    """`build_corner_table` with the plain slice-add backward."""

    @staticmethod
    def forward(ctx, v):
        ctx.shape = tuple(v.shape)
        return build_corner_table(v)

    @staticmethod
    def backward(ctx, ct):
        return corner_table_grad(ct, ctx.shape)


def corner_table(v: torch.Tensor) -> torch.Tensor:
    """Differentiable `build_corner_table`."""
    return CornerTable.apply(v)


def build_corner_table_level(v: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """JAX's contract: (NH, h, w, D) -> (NH, (h+2) * padded_width(w), 4D),
    rows indexed y * padded_width(w) + x in 1-based padded coordinates."""
    if tuple(v.shape[1:3]) != (h, w):
        raise ValueError(f"v is {tuple(v.shape)}, level is {(h, w)}")
    return corner_table(v[:, None])


def build_corner_tables(value_hd: torch.Tensor,
                        spatial_shapes: Sequence[Tuple[int, int]]
                        ) -> Tuple[List[torch.Tensor], List[int]]:
    """Every level's table from the (N, H, Len_in, D) value: (tables,
    strides), tables[lvl] (N*H, (h+2) * strides[lvl], 4D)."""
    sizes = [h * w for h, w in spatial_shapes]
    tables = [corner_table(v.unflatten(2, (h, w)))
              for v, (h, w) in zip(value_hd.split(sizes, dim=2),
                                   spatial_shapes)]
    return tables, [padded_width(w) for _, w in spatial_shapes]
