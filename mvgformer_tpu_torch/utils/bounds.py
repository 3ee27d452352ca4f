"""The compulsory work of each kernel and the least time the card could take
for it.

Each input byte is read once and each output byte written once. Where the
reads depend on the data (a gather, a bilinear read), only the table rows,
elements or pixels that these inputs touch are counted, once each. FLOPs
are the multiply-adds the function needs, on the CUDA cores in float32
(every kernel here sums in float32 outside the tensor cores).

    bound_ms = max(bytes / 3.35 TB/s, FLOPs / 67 TFLOP/s)

are the published rates of one H100 SXM (NVIDIA's data sheet) at its full
700 W; a card set to a lower power limit runs slower under load, so the
limit stands beside every bound that is written down. `chip_smoke.py`
computes each kernel's bound from the inputs of its timed run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from mvgformer_tpu_torch.ops.gather_forms import window_rows
from mvgformer_tpu_torch.ops.table_build import padded_width

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


@dataclasses.dataclass(frozen=True)
class Work:
    """Bytes moved and float32 operations done by one call."""

    bytes: int
    flops: int = 0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.flops + other.flops)

    @property
    def bytes_ms(self) -> float:
        return self.bytes / HBM_BYTES_PER_S * 1e3

    @property
    def flops_ms(self) -> float:
        return self.flops / FP32_FLOPS_PER_S * 1e3

    @property
    def bound_ms(self) -> float:
        return max(self.bytes_ms, self.flops_ms)

    @property
    def bound_by(self) -> str:
        return "bytes" if self.bytes_ms >= self.flops_ms else "operations"


def total(works: Sequence[Work]) -> Work:
    return sum(works, Work(0))


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def touched(keys: torch.Tensor, valid: Optional[torch.Tensor],
            space: int) -> int:
    """How many distinct keys in [0, space) the valid entries name."""
    mask = torch.zeros(space, dtype=torch.bool, device=keys.device)
    keys = keys.reshape(-1) if valid is None else keys[valid]
    mask[keys] = True
    return int(mask.sum())


# ---------------------------------------------------------------------------
# B1: deformable sampling
# ---------------------------------------------------------------------------


def _corners(y: torch.Tensor, x: torch.Tensor, h: int, w: int):
    """The in-bounds bilinear corners of pixel coordinates (y, x): pairs
    (flat pixel y * w + x, valid), four of them."""
    finite = torch.isfinite(x) & torch.isfinite(y)
    y0 = torch.floor(torch.where(finite, y, -2.0)).long()
    x0 = torch.floor(torch.where(finite, x, -2.0)).long()
    for dy in (0, 1):
        for dx in (0, 1):
            yy, xx = y0 + dy, x0 + dx
            ok = finite & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            yield yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1), ok


def deform_sample(value: torch.Tensor,
                  spatial_shapes: Sequence[Tuple[int, int]],
                  loc: torch.Tensor, aw: torch.Tensor) -> Work:
    """B1 on value (N, Len_in, H, D), locations (N, Lq, H, L, P, 2) and
    weights (N, Lq, H, L, P): the value rows (pixel, head) its in-bounds
    corners touch, the locations, weights and (N, Lq, H*D) output; 4 x D
    multiply-adds per sample."""
    N, len_in, H, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    n = torch.arange(N, device=loc.device)[:, None, None, None]
    hh = torch.arange(H, device=loc.device)[None, None, :, None]
    mask = torch.zeros(N * H * len_in, dtype=torch.bool, device=loc.device)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        x = loc[:, :, :, lvl, :, 0].float() * w - 0.5  # (N, Lq, H, P)
        y = loc[:, :, :, lvl, :, 1].float() * h - 0.5
        for pix, ok in _corners(y, x, h, w):
            mask[((n * H + hh) * len_in + start + pix)[ok]] = True
        start += h * w
    rows = int(mask.sum())
    out = N * Lq * H * D * value.element_size()
    return Work(rows * D * value.element_size() + nbytes(loc, aw) + out,
                2 * 4 * D * N * Lq * H * L * P)


# ---------------------------------------------------------------------------
# B2: the corner table; the slot patterns of the table probe
# ---------------------------------------------------------------------------


def table_build(pairs: int, h: int, w: int, D: int, esize: int) -> Work:
    """B2 (with any slot map) for one level: the (pairs, h, w, D)
    level read once and the (pairs, (h+2) * padded_width(w), 4D) table
    written."""
    return Work(pairs * h * w * D * esize
                + pairs * (h + 2) * padded_width(w) * 4 * D * esize)


# ---------------------------------------------------------------------------
# B3: the table gather-reduce
# ---------------------------------------------------------------------------


def table_gather_forward_counts(NH: int, R: int, S: int, D: int, esize: int,
                                rows: int) -> Work:
    """B3's forward with `rows` distinct table rows touched: those rows,
    idx (int32), w4 and the (NH, S, D) output; 4 x D multiply-adds per
    sample."""
    return Work(rows * 4 * D * esize + NH * S * 4 + NH * S * 4 * esize
                + NH * S * D * esize, 2 * 4 * D * NH * S)


def table_gather_backward_counts(NH: int, R: int, S: int, D: int,
                                 esize: int, rows: int) -> Work:
    """B3's backward: the forward's reads and the cotangent (NH, S, D); the
    whole (NH, R, 4D) grad_tables and the (NH, S, 4) grad_w4 written, in
    the table dtype; twice the forward's multiply-adds."""
    return Work(rows * 4 * D * esize + NH * S * 4 + NH * S * 4 * esize
                + NH * S * D * esize + NH * R * 4 * D * esize
                + NH * S * 4 * esize, 2 * 2 * 4 * D * NH * S)


def table_rows_touched(tables: torch.Tensor, idx: torch.Tensor) -> int:
    NH, R, _ = tables.shape
    p = torch.arange(NH, device=idx.device)[:, None]
    k = idx.long()
    return touched(p * R + k, (k >= 0) & (k < R), NH * R)


def table_gather_forward(tables, idx) -> Work:
    NH, R, C = tables.shape
    return table_gather_forward_counts(NH, R, idx.shape[1], C // 4,
                                       tables.element_size(),
                                       table_rows_touched(tables, idx))


def table_gather_backward(tables, idx) -> Work:
    NH, R, C = tables.shape
    return table_gather_backward_counts(NH, R, idx.shape[1], C // 4,
                                        tables.element_size(),
                                        table_rows_touched(tables, idx))


# ---------------------------------------------------------------------------
# B4, B5: the window kernels
# ---------------------------------------------------------------------------


def _window_corners(rel: torch.Tensor, H: int, P: int, K: int, Kw: int):
    """(keys of (row, head, point) window pixels gy * Kw + gx, valid) of the
    four tent corners of each packed rel row."""
    r = rel.float().reshape(rel.shape[0], H, 3, P)
    yield from _corners(r[:, :, 0], r[:, :, 1], K, Kw)


def window_block(tiles: torch.Tensor, rel: torch.Tensor,
                 block_tile: torch.Tensor, K: int, H: int, P: int, D: int,
                 block_rows: int) -> Work:
    """B4: the (tile, pixel, head) rows of `tiles` the samples' corners
    touch, rel, the block index and the (nrows, H*D) output."""
    n_tiles = tiles.shape[0]
    nrows = rel.shape[0]
    tile = block_tile.long().repeat_interleave(block_rows)[:nrows]
    hh = torch.arange(H, device=rel.device)[None, :, None]
    mask = torch.zeros(n_tiles * K * K * H, dtype=torch.bool,
                       device=rel.device)
    for pix, ok in _window_corners(rel, H, P, K, K):
        mask[((tile[:, None, None] * K * K + pix) * H + hh)[ok]] = True
    esize = tiles.element_size()
    return Work(int(mask.sum()) * D * esize + nbytes(rel, block_tile)
                + nrows * H * D * esize, 2 * 4 * D * nrows * H * P)


def window_dma(padded_map: torch.Tensor, rel: torch.Tensor,
               origins: torch.Tensor, K: int, H: int, P: int, D: int,
               block_rows: int, Kx: int) -> Work:
    """B5: the (view, pixel, head) rows of the padded map the samples'
    corners touch in their (K, Kx) windows, rel, the origins and the
    output."""
    V, hp, wp, _ = padded_map.shape
    nrows = rel.shape[0]
    org = origins.long().repeat_interleave(block_rows, dim=0)[:nrows]
    view, y0, x0 = (org[:, i, None, None] for i in range(3))
    hh = torch.arange(H, device=rel.device)[None, :, None]
    mask = torch.zeros(V * hp * wp * H, dtype=torch.bool, device=rel.device)
    for pix, ok in _window_corners(rel, H, P, K, Kx):
        gy, gx = pix // Kx, pix % Kx
        key = ((view * hp + y0 + gy) * wp + x0 + gx) * H + hh
        mask[key[ok]] = True
    esize = padded_map.element_size()
    return Work(int(mask.sum()) * D * esize + nbytes(rel, origins)
                + nrows * H * D * esize, 2 * 4 * D * nrows * H * P)


# ---------------------------------------------------------------------------
# the gather forms of the probes
# ---------------------------------------------------------------------------


def row_gather(tbl: torch.Tensor, idx: torch.Tensor) -> Work:
    """Rows touched, idx and the output."""
    if tbl.dim() == 2:
        tbl, idx = tbl[None], idx[None]
    rows = table_rows_touched(tbl, idx)
    row = tbl.shape[2] * tbl.element_size()
    return Work(rows * row + nbytes(idx) + idx.numel() * row)


def window_gather(tbl: torch.Tensor, base: torch.Tensor, local: torch.Tensor,
                  W: int, unit: int, mode: str) -> Work:
    """Rows the select or copy touches, base and local (as the kernel
    reads them) and the output."""
    P, S = local.shape
    R, C = tbl.shape[1:]
    out = P * S * C * tbl.element_size()
    if mode == "zero":
        return Work(out)
    rows, ok = window_rows(base, local, W, unit, mode)
    ok = ok & (rows >= 0) & (rows < R)
    p = torch.arange(P, device=local.device)[:, None]
    n = touched(p * R + rows.clamp(0, R - 1), ok, P * R)
    read = nbytes(base, local) if mode == "select" else nbytes(base)
    return Work(n * C * tbl.element_size() + read + out)


def take_along(tbl: torch.Tensor, idx: torch.Tensor, axis: int) -> Work:
    """Elements touched, idx and the output."""
    k = idx.long()
    rows, cols = tbl.shape
    if axis == 0:
        keys = k * cols + torch.arange(idx.shape[1], device=idx.device)
        ok = (k >= 0) & (k < rows)
    else:
        keys = torch.arange(idx.shape[0], device=idx.device)[:, None]
        keys = keys * cols + k
        ok = (k >= 0) & (k < cols)
    n = touched(keys, ok, rows * cols)
    return Work(n * tbl.element_size() + nbytes(idx)
                + idx.numel() * tbl.element_size())


def scale(n: int, esize: int) -> Work:
    """n elements read and written, one multiply each."""
    return Work(2 * n * esize, n)


# float32 operations per point of the serving DLT (csrc/dlt_jacobi.cu),
# each add, multiply, divide, square root and exponential counted once:
# per view the affine (8), the undistortion's 5 iterations and its ends
# (158), the softmax (4), the system's two rows twice over with the Gram
# matrix's 10 entries (96); per point the rescale (4), 36 rotations of 56
# and the dehomogenisation (7)
DLT_OPS_PER_VIEW = 8 + 158 + 4 + 96
DLT_OPS_PER_POINT = 4 + 36 * 56 + 7


def dlt_jacobi(B: int, N: int, V: int) -> Work:
    """B x N points over V views: each point's V refined 2D points (8 bytes)
    and logits (4), its mask byte and its 3D point (12); each frame and
    view's crop, camera and projection numbers (27 floats)."""
    points = B * N
    return Work(points * (12 * V + 1 + 12) + B * V * 27 * 4,
                points * (V * DLT_OPS_PER_VIEW + DLT_OPS_PER_POINT))


# float32 operations per point of the DLT's backward (csrc/dlt_jacobi.cu):
# the forward again (above), then its reverse: per view the system's rows
# in two passes (408), the clip and the softmax (16), the undistortion's
# iterates again and their reverse (393); per point the dehomogenisation
# and the rescale (28) and 36 rotations of about 100. A rotation's state
# replayed from its sweep's first state (90 rotations of 56) is not
# counted: a kernel that kept every state would not do that work.
DLT_BWD_OPS_PER_VIEW = DLT_OPS_PER_VIEW + 408 + 16 + 393
DLT_BWD_OPS_PER_POINT = DLT_OPS_PER_POINT + 28 + 36 * 100


def dlt_jacobi_bwd(B: int, N: int, V: int) -> Work:
    """The backward of `dlt_jacobi`'s call: its inputs read again with the
    cotangent of the 3D point (12 bytes a point), the cotangents of the
    refined points and logits written (12 a point and view)."""
    points = B * N
    return Work(points * (24 * V + 1 + 24) + B * V * 27 * 4,
                points * (V * DLT_BWD_OPS_PER_VIEW + DLT_BWD_OPS_PER_POINT))


# ---------------------------------------------------------------------------
# point-top-m in ProjAttn (serving)
# ---------------------------------------------------------------------------


def point_topm(N: int, Lq: int, H: int, Lt: int, P: int, m: int) -> Work:
    """Point-top-m of P points on N x Lq x H rows of Lt levels, float32:
    each row's Lt x P weights and Lt x P x 2 locations read, its Lt x m
    weights and Lt x m x 2 locations written; an add into the kept sum and
    a division per kept weight (the ranks are comparisons, no FLOPs)."""
    rows = N * Lq * H
    return Work(rows * Lt * (P + m) * 3 * 4, rows * Lt * m * 2)
