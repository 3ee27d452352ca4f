"""Corner-table gather-reduce: the Hopper kernels of B3 (forward and
backward), their plain PyTorch versions and the autograd function around
them.

Port of the contract of `mvgformer_tpu/ops/onehot_gather.py`:

    deform_gather_reduce(tables (NH, R, 4D), idx (NH, S) int32,
                         w4 (NH, S, 4)) -> (NH, S, D)
    out[p, s] = sum_c tables[p, idx[p, s], c*D:(c+1)*D] * w4[p, s, c]

for every input. The TPU form sorts the samples and selects rows with a
one-hot matmul, repairing the samples that escape a block's window; a
Hopper warp gathers rows directly, so none of that is ported.

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
import functools
from typing import Tuple

import torch

from mvgformer_tpu_torch.ops import _build

_SRC = _build.CSRC / "table_gather.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(_SRC)
    fwd = lib.mvg_table_gather_forward
    fwd.restype = ctypes.c_int
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    bwd = lib.mvg_table_gather_backward
    bwd.restype = ctypes.c_int
    bwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    return lib


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
    """The gathered rows (NH, S, 4, D)."""
    NH, _, C = tables.shape
    rows = torch.gather(tables, 1, idx.long()[..., None].expand(-1, -1, C))
    return rows.reshape(NH, idx.shape[1], 4, C // 4)


def deform_gather_reduce_plain(tables: torch.Tensor, idx: torch.Tensor,
                               w4: torch.Tensor) -> torch.Tensor:
    """The plain version: a gather and a sum, float32 sums, the result in
    the dtype of tables. Its autograd is the plain backward."""
    rows = _rows(tables, idx).float()
    out = (rows * w4.float()[..., None]).sum(dim=2)
    return out.to(tables.dtype)


def gather_reduce_backward_plain(tables, idx, w4, ct
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grad_tables, grad_w4) of the contract for cotangent ct, in float32
    sums, cast to the dtypes of tables and w4."""
    NH, R, C = tables.shape
    g = ct.float()[:, :, None, :]  # (NH, S, 1, D)
    grad_w4 = (_rows(tables, idx).float() * g).sum(dim=-1)
    contrib = (w4.float()[..., None] * g).reshape(NH, -1, C)
    grad_tables = torch.zeros((NH, R, C), dtype=torch.float32,
                              device=tables.device)
    grad_tables.scatter_add_(1, idx.long()[..., None].expand(-1, -1, C),
                             contrib)
    return grad_tables.to(tables.dtype), grad_w4.to(w4.dtype)


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
    out = torch.empty((NH, S, C // 4), dtype=tables.dtype,
                      device=tables.device)
    fn = _library().mvg_table_gather_forward
    with torch.cuda.device(tables.device):
        stream = torch.cuda.current_stream(tables.device).cuda_stream
        err = fn(tables.data_ptr(), idx.data_ptr(), w4.data_ptr(),
                 out.data_ptr(), NH, R, S, C // 4, _DTYPE_CODE[tables.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"table_gather forward kernel launch failed: "
                           f"error {err}")
    gather_reduce_forward.launches += 1
    return out


gather_reduce_forward.launches = 0


def gather_reduce_backward(tables: torch.Tensor, idx: torch.Tensor,
                           w4: torch.Tensor, ct: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grad_tables (NH, R, 4D), grad_w4 (NH, S, 4)) for cotangent ct
    (NH, S, D), in the dtypes of tables and w4. On CUDA one kernel writes
    both: float32 atomic adds into a zeroed buffer, cast to the table dtype
    at the end (no cast for float32 tables)."""
    _check(tables, idx, w4, ct)
    if tables.device.type == "cpu":
        with torch.no_grad():
            return gather_reduce_backward_plain(tables, idx, w4, ct)
    if tables.device.type != "cuda":
        raise ValueError(f"unsupported device {tables.device}")
    _check_cuda(tables, idx, w4, ct)
    NH, R, C = tables.shape
    S = idx.shape[1]
    grad_tables = torch.zeros((NH, R, C), dtype=torch.float32,
                              device=tables.device)
    grad_w4 = torch.empty((NH, S, 4), dtype=tables.dtype,
                          device=tables.device)
    fn = _library().mvg_table_gather_backward
    with torch.cuda.device(tables.device):
        stream = torch.cuda.current_stream(tables.device).cuda_stream
        err = fn(tables.data_ptr(), idx.data_ptr(), w4.data_ptr(),
                 ct.data_ptr(), grad_tables.data_ptr(), grad_w4.data_ptr(),
                 NH, R, S, C // 4, _DTYPE_CODE[tables.dtype], stream)
    if err != 0:
        raise RuntimeError(f"table_gather backward kernel launch failed: "
                           f"error {err}")
    gather_reduce_backward.launches += 1
    return grad_tables.to(tables.dtype), grad_w4


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
