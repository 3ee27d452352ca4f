"""The gather forms of the probe kernels: the wrappers of the Hopper kernels
in `csrc/gather_forms.cu` (and of B2's, `csrc/table_build.cu`, for the
table slots) and their plain PyTorch versions.

The Pallas kernels of `tools/probes/` compute five functions, and the port
has one kernel for each (the row gather's serves two wrappers; the table
slots are B2's kernel with a slot map):

    row_gather(tbl (P, R, C), idx (P, S))          -> (P, S, C)
        out[p, i] = tbl[p, idx[p, i]]: jnp.take, lax.gather, dynamic row
        slices, and the one-hot products over all rows;
    window_gather(tbl (P, R, C), base (P, nblk), local (P, S), W, unit, mode)
        the windowed one-hot selects: block b = i // (S / nblk) reads the
        window of W rows at unit * base[p, b]; mode 'select' takes row
        local[p, i] of it, 'copy' row i - b * BS, 'zero' writes zeros;
    take_along(tbl, idx (S, C), axis)               -> (S, C)
        jnp.take_along_axis on axis 0 or 1;
    scale(x, a)                                     -> a * x
    table_slots(v (NH, h, w, D), slots)             -> (NH, (h+2)*wpp, 4D)
        the corner-table layout of B2 with each of its 4 slots taken from
        the row itself ("cur", 0) or the next ("nxt", 1), shifted by 0 or 1
        in x, or off; B2_SLOTS is B2's own map, and B2's kernel runs
        every map (`slot_codes` gives the codes it is handed).

A row, element or slot whose index lies off the table (or off the window)
is zero in both versions.

    * Each wrapper sends a CPU tensor to the plain version and a CUDA tensor
      to its kernel, or raises; nothing falls back. Its `.launches` counts
      its own kernel launches and nothing else changes it (`table_slots`
      leaves B2's `build_corner_table.launches` as it is).
    * The copies move raw bits, so the kernels equal the plain versions bit
      for bit in float32 and bfloat16; `scale` rounds its float32 product
      once, as the plain version does.

The port's model never calls these: `mvgformer_tpu_torch/tools/probes/`
does, with the PyTorch call of the same function timed beside each kernel.
`noop` launches an empty kernel: the launch floor, timed beside them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from mvgformer_tpu_torch.ops import _build, table_build
from mvgformer_tpu_torch.ops.table_build import padded_width

_SRC = _build.CSRC / "gather_forms.cu"
_DTYPES = (torch.float32, torch.bfloat16)
_MODES = {"select": 1, "copy": 2, "zero": 3}

Slot = Optional[Tuple[int, int]]  # (row: 0 cur / 1 nxt, x shift: 0 / 1)
# the store patterns of probe_table_kernel_forms.py::form_d; d3 equals d1
# once the columns the TPU left unwritten are zero
SLOT_MAPS = {
    "d0": ((0, 0), None, None, None),
    "d1": ((0, 0), (0, 0), (1, 0), (1, 0)),
    "d2": ((0, 1), (0, 0), (1, 1), (1, 0)),
    "d3": ((0, 0), (0, 0), (1, 0), (1, 0)),
    "d4": ((0, 1), (0, 1), (0, 1), (0, 1)),
}
B2_SLOTS = SLOT_MAPS["d2"]


_P, _I = ctypes.c_void_p, ctypes.c_int
_ROW_GATHER = _build.Launcher(_SRC, "mvg_row_gather", [_P] * 4 + [_I] * 8 + [_P])
_TAKE_ALONG = _build.Launcher(_SRC, "mvg_take_along", [_P] * 3 + [_I] * 6 + [_P])
_SCALE = _build.Launcher(_SRC, "mvg_scale",
                         [_P, _P, ctypes.c_longlong, ctypes.c_float, _I, _P])
_NOOP = _build.Launcher(_SRC, "mvg_noop", [_P])


def _check_device(*tensors) -> str:
    index = tensors[0].get_device()  # -1 off the card
    if any(t.get_device() != index for t in tensors[1:]) or (
            index < 0 and any(t.is_cuda for t in tensors)):
        raise ValueError(f"inputs on several devices: "
                         f"{[str(t.device) for t in tensors]}")
    if index >= 0:
        return "cuda"
    kind = tensors[0].device.type
    if kind != "cpu" or any(t.device.type != "cpu" for t in tensors[1:]):
        raise ValueError(f"unsupported device {tensors[0].device}")
    return kind


def _check_cuda(data: Sequence[Tuple[str, torch.Tensor]],
                index: Sequence[Tuple[str, torch.Tensor]]) -> None:
    for name, t in data:
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
    for name, t in index:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (*data, *index):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _masked_rows(tbl: torch.Tensor, rows: torch.Tensor,
                 ok: torch.Tensor) -> torch.Tensor:
    """tbl[p, rows[p, i]] where ok, else a zero row: (P, S, C)."""
    R, C = tbl.shape[1:]
    ok = ok & (rows >= 0) & (rows < R)
    got = torch.gather(tbl, 1, rows.clamp(0, R - 1)[..., None].expand(
        -1, -1, C))
    return torch.where(ok[..., None], got, torch.zeros((), dtype=tbl.dtype,
                                                       device=tbl.device))


# ---------------------------------------------------------------------------
# row gather
# ---------------------------------------------------------------------------


def row_gather_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(P, R, C), (P, S) -> (P, S, C); or (R, C), (S,) -> (S, C)."""
    if tbl.dim() == 2:
        return row_gather_plain(tbl[None], idx[None])[0]
    return _masked_rows(tbl, idx.long(), torch.ones_like(idx, dtype=bool))


def _check_rows(tbl, idx):
    if tbl.dim() != 3 or idx.dim() != 2 or idx.shape[0] != tbl.shape[0]:
        raise ValueError(f"tbl must be (P, R, C) and idx (P, S), got "
                         f"{tuple(tbl.shape)} and {tuple(idx.shape)}")


def row_gather(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[p, i] = tbl[p, idx[p, i]] (zero rows for indices off the table),
    for tbl (P, R, C) and idx (P, S), or tbl (R, C) and idx (S,). On CUDA:
    tbl float32 or bfloat16, idx int32, both contiguous."""
    if tbl.dim() == 2 and idx.dim() == 1:
        return row_gather(tbl[None], idx[None])[0]
    _check_rows(tbl, idx)
    if _check_device(tbl, idx) == "cpu":
        return row_gather_plain(tbl, idx)
    _check_cuda([("tbl", tbl)], [("idx", idx)])
    P, R, C = tbl.shape
    S = idx.shape[1]
    out = torch.empty((P, S, C), dtype=tbl.dtype, device=tbl.device)
    _ROW_GATHER(tbl, tbl.data_ptr(), idx.data_ptr(), None, out.data_ptr(),
                P, R, S, 0, 0, 0, 0, C * tbl.element_size())
    row_gather.launches += 1
    return out


row_gather.launches = 0


def window_rows(base: torch.Tensor, local: torch.Tensor, W: int,
                unit: int = 8, mode: str = "select"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (P, S) int64 table rows a windowed select ('select') or copy
    ('copy') reads, and where the select's offset lies in its window."""
    P, S = local.shape
    BS = S // base.shape[1]
    origin = unit * base.long().repeat_interleave(BS, dim=1)
    if mode == "select":
        off = local.long()
        return origin + off, (off >= 0) & (off < W)
    off = torch.arange(BS, device=local.device).repeat(base.shape[1])
    return origin + off, torch.ones_like(local, dtype=bool)


def window_gather_plain(tbl: torch.Tensor, base: torch.Tensor,
                        local: torch.Tensor, W: int, unit: int = 8,
                        mode: str = "select") -> torch.Tensor:
    """The windowed select, copy or zero of `window_gather`."""
    if mode == "zero":
        return torch.zeros(local.shape + tbl.shape[2:], dtype=tbl.dtype,
                           device=tbl.device)
    return _masked_rows(tbl, *window_rows(base, local, W, unit, mode))


def window_gather(tbl: torch.Tensor, base: torch.Tensor, local: torch.Tensor,
                  W: int, unit: int = 8, mode: str = "select"
                  ) -> torch.Tensor:
    """The windowed row gather of the one-hot window kernels, (P, S, C).

    The S = nblk * BS samples of pair p fall in nblk blocks of BS; block b
    owns the W-row window at row unit * base[p, b] of tbl[p]. Mode
    'select': sample i takes the window's row local[p, i] (a zero row for
    local outside [0, W)); 'copy': the window's row i - b * BS (the
    window's first BS rows, BS <= W); 'zero': zeros. Rows off the table are
    zero. base (P, nblk) and local (P, S) are int32; on CUDA all contiguous,
    tbl float32 or bfloat16."""
    _check_rows(tbl, local)
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {sorted(_MODES)}, got {mode!r}")
    P, S = local.shape
    if base.dim() != 2 or base.shape[0] != P or S % base.shape[1] != 0:
        raise ValueError(f"base must be (P, nblk) with nblk dividing S = "
                         f"{S}, got {tuple(base.shape)}")
    if mode == "copy" and S // base.shape[1] > W:
        raise ValueError(f"mode 'copy' needs BS = {S // base.shape[1]} <= "
                         f"W = {W}")
    if _check_device(tbl, base, local) == "cpu":
        return window_gather_plain(tbl, base, local, W, unit, mode)
    _check_cuda([("tbl", tbl)], [("base", base), ("local", local)])
    R, C = tbl.shape[1:]
    out = torch.empty((P, S, C), dtype=tbl.dtype, device=tbl.device)
    _ROW_GATHER(tbl, tbl.data_ptr(), local.data_ptr(), base.data_ptr(),
                out.data_ptr(), P, R, S, base.shape[1], W, unit,
                _MODES[mode], C * tbl.element_size())
    window_gather.launches += 1
    return out


window_gather.launches = 0


# ---------------------------------------------------------------------------
# take-along, scale
# ---------------------------------------------------------------------------


def take_along_plain(tbl: torch.Tensor, idx: torch.Tensor,
                     axis: int) -> torch.Tensor:
    """(R, C) with (S, C) on axis 0, or (S, K) with (S, C) on axis 1."""
    n = tbl.shape[axis]
    k = idx.long()
    ok = (k >= 0) & (k < n)
    got = torch.gather(tbl, axis, k.clamp(0, n - 1))
    return torch.where(ok, got, torch.zeros((), dtype=tbl.dtype,
                                            device=tbl.device))


def take_along(tbl: torch.Tensor, idx: torch.Tensor,
               axis: int) -> torch.Tensor:
    """jnp.take_along_axis(tbl, idx, axis) for 2-D operands: axis 0,
    out[i, j] = tbl[idx[i, j], j] (tbl (R, C), idx (S, C)); axis 1,
    out[i, j] = tbl[i, idx[i, j]] (tbl (S, K), idx (S, C)). Elements off
    the table are zero. On CUDA: tbl float32 or bfloat16, idx int32, both
    contiguous."""
    if tbl.dim() != 2 or idx.dim() != 2 or axis not in (0, 1):
        raise ValueError(f"2-D tbl and idx on axis 0 or 1, got "
                         f"{tuple(tbl.shape)}, {tuple(idx.shape)}, {axis}")
    other = 1 - axis
    if tbl.shape[other] != idx.shape[other]:
        raise ValueError(f"tbl {tuple(tbl.shape)} and idx "
                         f"{tuple(idx.shape)} differ on axis {other}")
    if _check_device(tbl, idx) == "cpu":
        return take_along_plain(tbl, idx, axis)
    _check_cuda([("tbl", tbl)], [("idx", idx)])
    out = torch.empty(idx.shape, dtype=tbl.dtype, device=tbl.device)
    _TAKE_ALONG(tbl, tbl.data_ptr(), idx.data_ptr(), out.data_ptr(),
                tbl.shape[0], tbl.shape[1], idx.shape[0], idx.shape[1], axis,
                tbl.element_size())
    take_along.launches += 1
    return out


take_along.launches = 0


def scale_plain(x: torch.Tensor, a: float) -> torch.Tensor:
    """a * x with a float32 product rounded once to the dtype of x."""
    return (x.float() * a).to(x.dtype)


def scale(x: torch.Tensor, a: float) -> torch.Tensor:
    """a * x, float32 or bfloat16, in the dtype of x; contiguous on CUDA."""
    if _check_device(x) == "cpu":
        return scale_plain(x, a)
    _check_cuda([("x", x)], [])
    out = torch.empty_like(x)
    _SCALE(x, x.data_ptr(), out.data_ptr(), x.numel(), float(a),
           _DTYPES.index(x.dtype))
    scale.launches += 1
    return out


scale.launches = 0


# ---------------------------------------------------------------------------
# corner-table slots
# ---------------------------------------------------------------------------


def slot_codes(slots: Sequence[Slot]) -> Tuple[int, ...]:
    """The 4 slot codes that `csrc/table_build.cu` takes for a slot map: -1
    for a slot that is off, else 2 * row + shift. B2_SLOTS gives
    table_build.B2_CODES, B2's own compile-time instance."""
    if len(slots) != 4:
        raise ValueError(f"4 slots, got {len(slots)}")
    codes = []
    for s in slots:
        if s is None:
            codes.append(-1)
        elif tuple(s) in ((0, 0), (0, 1), (1, 0), (1, 1)):
            codes.append(2 * s[0] + s[1])
        else:
            raise ValueError(f"a slot is None or (row 0/1, shift 0/1), got "
                             f"{s!r}")
    return tuple(codes)


def table_slots_plain(v: torch.Tensor, slots: Sequence[Slot]) -> torch.Tensor:
    """(NH, h, w, D) -> (NH, (h+2) * padded_width(w), 4D) with pads and
    slices, as `table_build.build_corner_table_plain`."""
    slot_codes(slots)
    NH, h, w, D = v.shape
    wpp = padded_width(w)
    # p[y + 1, x + 1] = v[y, x]; slot (row, shift) of table row (y, x) is
    # v[y - 1 + row, x - shift] = p[y + row, x + 1 - shift]
    p = F.pad(v, (0, 0, 1, wpp - w, 1, 2))  # (NH, h+3, wpp+1, D)
    zero = torch.zeros((NH, h + 2, wpp, D), dtype=v.dtype, device=v.device)
    parts = [zero if s is None else
             p[:, s[0]:s[0] + h + 2, 1 - s[1]:1 - s[1] + wpp] for s in slots]
    return torch.cat(parts, dim=-1).reshape(NH, (h + 2) * wpp, 4 * D)


def table_slots(v: torch.Tensor, slots: Sequence[Slot] = B2_SLOTS
                ) -> torch.Tensor:
    """The corner-table layout of v (NH, h, w, D) with the slot map
    `slots` (4 entries, each None or (row, shift)); with B2_SLOTS it is
    B2's table. On CUDA: float32 or bfloat16, contiguous; B2's kernel
    runs it, reading v as N = NH views of H = 1 head."""
    codes = slot_codes(slots)
    if v.dim() != 4:
        raise ValueError(f"v must be (NH, h, w, D), got {tuple(v.shape)}")
    if _check_device(v) == "cpu":
        return table_slots_plain(v, slots)
    _check_cuda([("v", v)], [])
    out = table_build.launch_table(v[:, None], codes)
    table_slots.launches += 1
    return out


table_slots.launches = 0


def noop(t: torch.Tensor) -> None:
    """One launch of an empty kernel on the current stream of t's card:
    the least a launch costs, timed beside the kernels."""
    if not t.is_cuda:
        raise ValueError(f"noop launches on a card, got {t.device}")
    _NOOP(t)


KERNELS = (row_gather, window_gather, take_along, scale, table_slots)
