"""Corner-table gather-reduce: the Hopper kernels of B3 (forward and
backward), their plain PyTorch versions and the autograd function around
them.

Port of the contract of `mvgformer_tpu/ops/onehot_gather.py`:

    deform_gather_reduce(tables (NH, R, 4D), idx (NH, S) int32,
                         w4 (NH, S, 4)) -> (NH, S, D)
    out[p, s] = sum_c tables[p, idx[p, s], c*D:(c+1)*D] * w4[p, s, c]

for every idx in [0, R). An index off the table reads no row here: its
output is zero and it adds to no gradient, in the plain versions and the
kernels alike. JAX's `_reference_reduce`
(`mvgformer_tpu/ops/onehot_gather.py:113-121`) gathers it with
`jnp.take_along_axis` instead, which gives NaN rows for idx >= R and wraps
idx = -1 to row R - 1. The samplers never make such an index:
`ops/sampling.py::corner_samples` clamps every index into the padded
table, as JAX's does. The TPU form sorts the samples and selects rows with a
one-hot matmul, repairing the samples that escape a block's window; a
Hopper thread gathers rows directly, so the forward has no sort, window or
repair. The backward keeps the sort (`row_segments`, plain torch outside the
kernel, as JAX's sort is outside its pallas_call): sorted by row, the
scatter-add into grad_tables becomes a segmented sum that writes each row
once, with no atomics.

    * `gather_reduce_forward` and `gather_reduce_backward` are the kernels'
      wrappers (`csrc/table_gather.cu`): a CPU tensor goes to the plain
      version, a CUDA tensor launches the kernel or raises. Their `.launches`
      count kernel launches; nothing else changes them.
    * `deform_gather_reduce` is the autograd function: its forward and
      backward are those two wrappers. The backward's residuals are the
      tables, idx and w4, never the gathered (NH, S, 4D) rows that plain
      autograd of a gather keeps (`deform_gather_reduce_plain`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from mvgformer_tpu_torch.ops import _build

_SRC = _build.CSRC / "table_gather.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# sorted samples per tile of the backward's segment_sum kernel
CHUNK = 64
_P, _I = ctypes.c_void_p, ctypes.c_int
_FORWARD = _build.Launcher(_SRC, "mvg_table_gather_forward",
                           [_P] * 4 + [_I] * 6 + [_P])
_BACKWARD = _build.Launcher(_SRC, "mvg_table_gather_backward",
                            [_P] * 9 + [_I] * 7 + [_P])


def _check(tables, idx, w4, ct=None):
    if tables.dim() != 3 or tables.shape[-1] % 4 != 0:
        raise ValueError(f"tables must be (NH, R, 4D), got "
                         f"{tuple(tables.shape)}")
    NH, R, _ = tables.shape
    if idx.dim() != 2 or idx.shape[0] != NH:
        raise ValueError(f"idx must be (NH, S), got {tuple(idx.shape)}")
    S = idx.shape[1]
    if tuple(w4.shape) != (NH, S, 4):
        raise ValueError(f"w4 must be (NH, S, 4) = {(NH, S, 4)}, got "
                         f"{tuple(w4.shape)}")
    if ct is not None and tuple(ct.shape) != (NH, S, tables.shape[-1] // 4):
        raise ValueError(f"ct is {tuple(ct.shape)}, expected "
                         f"{(NH, S, tables.shape[-1] // 4)}")
    devices = {t.device for t in (tables, idx, w4, ct) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


def _check_cuda(tables, idx, w4, ct=None):
    if tables.dtype not in _DTYPE_CODE:
        raise TypeError(f"tables must be float32 or bfloat16, got "
                        f"{tables.dtype}")
    for name, t in (("w4", w4), ("ct", ct)):
        if t is not None and t.dtype != tables.dtype:
            raise TypeError(f"{name} is {t.dtype}, tables are "
                            f"{tables.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    for name, t in (("tables", tables), ("idx", idx), ("w4", w4),
                    ("ct", ct)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _rows(tables: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The gathered rows (NH, S, 4, D); zero rows for indices off the
    table."""
    NH, R, C = tables.shape
    k = idx.long()
    rows = torch.gather(tables, 1, k.clamp(0, R - 1)[..., None].expand(
        -1, -1, C))
    ok = ((k >= 0) & (k < R))[..., None]
    rows = torch.where(ok, rows, torch.zeros((), dtype=tables.dtype,
                                             device=tables.device))
    return rows.reshape(NH, idx.shape[1], 4, C // 4)


def deform_gather_reduce_plain(tables: torch.Tensor, idx: torch.Tensor,
                               w4: torch.Tensor) -> torch.Tensor:
    """The plain version: a gather and a sum, float32 sums, the result in
    the dtype of tables. Its autograd is the plain backward. An index off
    the table gives a zero row (JAX's `_reference_reduce` gives NaN or
    wraps; see the module's docstring)."""
    rows = _rows(tables, idx).float()
    out = (rows * w4.float()[..., None]).sum(dim=2)
    return out.to(tables.dtype)


def gather_reduce_backward_plain(tables, idx, w4, ct
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grad_tables, grad_w4) of the contract for cotangent ct, in float32
    sums, cast to the dtypes of tables and w4. An index off the table adds
    to no row and has grad_w4 0 (JAX's VJP of `_reference_reduce` differs
    there; see the module's docstring)."""
    NH, R, C = tables.shape
    g = ct.float()[:, :, None, :]  # (NH, S, 1, D)
    grad_w4 = (_rows(tables, idx).float() * g).sum(dim=-1)
    k = idx.long()
    ok = (k >= 0) & (k < R)
    contrib = (w4.float()[..., None] * g).reshape(NH, -1, C)
    contrib = contrib * ok[..., None]
    grad_tables = torch.zeros((NH, R, C), dtype=torch.float32,
                              device=tables.device)
    grad_tables.scatter_add_(1, k.clamp(0, R - 1)[..., None].expand(
        -1, -1, C), contrib)
    return grad_tables.to(tables.dtype), grad_w4.to(w4.dtype)


class Segments(NamedTuple):
    """The samples of (NH, S) indices sorted by (pair, row), for the
    backward kernel: keys (NH*S,) int32, the sorted p * (R + 1) + row (row
    R for an index off the table, so those sort last in their pair); perm
    (NH*S,) int64, the flat sample p * S + s at each sorted position, stable;
    offsets (NH, R + 1) int32, the sorted position where row r of pair p
    starts (offsets[p, R] is where its rows end)."""
    keys: torch.Tensor
    perm: torch.Tensor
    offsets: torch.Tensor


def row_segments(idx: torch.Tensor, R: int) -> Segments:
    """Sort the samples of idx (NH, S) by row: one stable 1-D sort of the
    flattened keys, and the row offsets by a binary search of every
    (pair, row) key. Plain torch on any device."""
    NH, S = idx.shape
    if NH * (R + 1) >= 2 ** 31 or NH * S >= 2 ** 31:
        raise ValueError(f"NH * (R + 1) = {NH * (R + 1)} and NH * S = "
                         f"{NH * S} must fit in int32")
    row = torch.where((idx >= 0) & (idx < R), idx, R).int()
    pair = torch.arange(NH, dtype=torch.int32, device=idx.device)[:, None]
    keys, perm = torch.sort((pair * (R + 1) + row).reshape(-1), stable=True)
    every = torch.arange(NH * (R + 1), dtype=torch.int32, device=idx.device)
    offsets = torch.searchsorted(keys, every, out_int32=True)
    return Segments(keys, perm, offsets.view(NH, R + 1))


def _check_segments(segments: Segments, NH: int, R: int, S: int,
                    device: torch.device) -> None:
    """What the backward kernel reads through the segments of a caller."""
    want = {"keys": ((NH * S,), torch.int32), "perm": ((NH * S,), torch.int64),
            "offsets": ((NH, R + 1), torch.int32)}
    for name, (shape, dtype) in want.items():
        t = getattr(segments, name)
        if (tuple(t.shape) != shape or t.dtype != dtype or t.device != device
                or not t.is_contiguous()):
            raise ValueError(f"segments.{name} must be a contiguous {dtype} "
                             f"{shape} on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _aligned(tensors, nbytes: int) -> bool:
    return all(t.data_ptr() % nbytes == 0 for t in tensors)


def vector_bytes(tables: torch.Tensor, other: torch.Tensor) -> int:
    """The bytes a thread of the forward moves: 16 where a row's D elements
    are whole 16-byte vectors and both pointers are 16-byte aligned, else
    one element (the scalar instance)."""
    esize = tables.element_size()
    return esize * _build.vector_width(tables.shape[-1] // 4, esize, tables,
                                       other)


def lane_elements(tables: torch.Tensor, ct: torch.Tensor) -> int:
    """The backward kernel's instance: D / 8 channels of the 4D row per
    lane, read as 16-byte vectors, for D in {8, 16, 32, 64} with tables and
    ct 16-byte aligned (grad_tables is a fresh allocation, aligned); else
    0, the generic instance."""
    D = ct.shape[-1]
    epl = D // 8
    if D % 8 or epl not in (1, 2, 4, 8):
        return 0
    return epl if _aligned((tables, ct), 16) else 0


def gather_reduce_forward(tables: torch.Tensor, idx: torch.Tensor,
                          w4: torch.Tensor) -> torch.Tensor:
    """(NH, S, D) gather-reduce, no autograd. On CUDA: tables and w4
    float32 or bfloat16 (one dtype), idx int32, all contiguous."""
    _check(tables, idx, w4)
    if tables.device.type == "cpu":
        with torch.no_grad():
            return deform_gather_reduce_plain(tables, idx, w4)
    if tables.device.type != "cuda":
        raise ValueError(f"unsupported device {tables.device}")
    _check_cuda(tables, idx, w4)
    NH, R, C = tables.shape
    S = idx.shape[1]
    D = C // 4
    out = torch.empty((NH, S, D), dtype=tables.dtype, device=tables.device)
    _FORWARD(tables, tables.data_ptr(), idx.data_ptr(), w4.data_ptr(),
             out.data_ptr(), NH, R, S, D, _DTYPE_CODE[tables.dtype],
             vector_bytes(tables, out))
    gather_reduce_forward.launches += 1
    return out


gather_reduce_forward.launches = 0


def gather_reduce_backward(tables: torch.Tensor, idx: torch.Tensor,
                           w4: torch.Tensor, ct: torch.Tensor,
                           segments: Optional[Segments] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grad_tables (NH, R, 4D), grad_w4 (NH, S, 4)) for cotangent ct
    (NH, S, D), in the dtypes of tables and w4. On CUDA: the samples sorted
    by row (`row_segments`, unless the caller passes them), then one kernel
    stages each tile of sorted samples, writes their grad_w4 and sums
    grad_tables by row, and a second writes the rows no tile wrote alone:
    both in the table dtype, every row once, bit-identical from launch to
    launch."""
    _check(tables, idx, w4, ct)
    if tables.device.type == "cpu":
        with torch.no_grad():
            return gather_reduce_backward_plain(tables, idx, w4, ct)
    if tables.device.type != "cuda":
        raise ValueError(f"unsupported device {tables.device}")
    _check_cuda(tables, idx, w4, ct)
    NH, R, C = tables.shape
    S = idx.shape[1]
    if segments is None:
        segments = row_segments(idx, R)
    else:
        _check_segments(segments, NH, R, S, idx.device)
    keys, perm, offsets = segments
    tiles = -(-NH * S // CHUNK)
    partials = torch.empty((tiles, 2, C), dtype=torch.float32,
                           device=tables.device)
    grad_tables = torch.empty_like(tables)
    grad_w4 = torch.empty((NH, S, 4), dtype=tables.dtype,
                          device=tables.device)
    _BACKWARD(tables, tables.data_ptr(), w4.data_ptr(), ct.data_ptr(),
              keys.data_ptr(), perm.data_ptr(), offsets.data_ptr(),
              partials.data_ptr(), grad_tables.data_ptr(), grad_w4.data_ptr(),
              NH, R, S, C // 4, CHUNK, _DTYPE_CODE[tables.dtype],
              lane_elements(tables, ct))
    gather_reduce_backward.launches += 1
    return grad_tables, grad_w4


gather_reduce_backward.launches = 0


class DeformGatherReduce(torch.autograd.Function):
    """The contract with the kernels' forward and backward (the plain
    versions on the CPU)."""

    @staticmethod
    def forward(ctx, tables, idx, w4):
        ctx.save_for_backward(tables, idx, w4)
        return gather_reduce_forward(tables, idx, w4)

    @staticmethod
    def backward(ctx, ct):
        tables, idx, w4 = ctx.saved_tensors
        grad_tables, grad_w4 = gather_reduce_backward(tables, idx, w4,
                                                      ct.contiguous())
        return grad_tables, None, grad_w4


def deform_gather_reduce(tables: torch.Tensor, idx: torch.Tensor,
                         w4: torch.Tensor) -> torch.Tensor:
    """Differentiable gather-reduce with respect to tables and w4."""
    return DeformGatherReduce.apply(tables, idx, w4)
