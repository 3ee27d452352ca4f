"""Windowed layer-1 deformable sampling (rig-static tile bucketing).

Port of `mvgformer_tpu/ops/window_sampling.py`. MVGFormer's first decoder
layer samples around centers that are the static `sample_space` grid
projected through a fixed camera rig, so a host-side plan, built once per
rig, can bucket each (view, query, level) into a static feature-map tile.
Only the learned offsets change per frame. Each level then samples through
one of the window kernels:

    impl 'pallas' and 'xla' -> `ops/window_block.py` over tile windows cut
                               from the zero-padded map (`_tile_windows`);
    impl 'pallas_dma'       -> `ops/window_dma.py` straight from the padded
                               map, in windows widened to Kx columns.

On the CPU, impl 'xla' runs the plain blocked einsum with `row_dtype`
weight rows, as the JAX package's 'xla' impl does; the other impls and
every CUDA call go through the kernels' wrappers.

Semantics against the exact sampler (`ops/sampling.py`): identical for a
sample whose offset stays within `halo - 2` px of its query's center (always
true at offset init with the default halo `dec_n_points + 2`). A sample that
escapes its window reads zero; its attention mass, counted only where its
stencil touches the real map, is returned as `escaped_mass`. Under
'pallas_dma' the window is wider (Kx >= K columns of real neighbouring
data), so fewer samples escape and the result can differ from 'pallas'.
"""

from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mvgformer_tpu_torch.ops.window_block import (window_block_matmul,
                                                  window_block_matmul_plain)
from mvgformer_tpu_torch.ops.window_dma import window_block_dma

IMPLS = ("xla", "pallas", "pallas_dma")
_ARRAYS = ("row_query", "row_valid", "row_origin", "block_tile", "inv_perm")


class LevelPlan(NamedTuple):
    """Static bucketing of one level across all views (host-built)."""

    K: int                    # window side = tile + 2 * halo
    tile: int
    pad: int                  # map zero-padding on each side
    block_rows: int
    row_query: np.ndarray     # (V, nrows) query id per row (tile-sorted)
    row_valid: np.ndarray     # (V, nrows) 1.0 real row / 0.0 padding
    row_origin: np.ndarray    # (V, nrows, 2) window origin (x0, y0) in
    #                           PADDED pixel coords
    block_tile: np.ndarray    # (V, nblocks) tile id per block
    inv_perm: np.ndarray      # (V, Lq) row index holding query q
    n_tiles: int
    grid_hw: Tuple[int, int]  # (nty, ntx)
    Kx: int                   # 'pallas_dma' window width: K widened so
    #                           every 8-aligned-down origin still covers K


class WindowPlan(NamedTuple):
    levels: Tuple[LevelPlan, ...]
    halo: int
    impl: str = "xla"  # 'xla' | 'pallas' | 'pallas_dma'

    def to(self, device) -> "WindowPlan":
        """The plan with its index arrays as tensors on `device`. Call it
        once per rig: `window_sample` then copies nothing per frame."""
        def move(a, name):
            t = torch.as_tensor(a, device=device)
            return t.float() if name == "row_valid" else t.long()

        return self._replace(levels=tuple(
            lp._replace(**{n: move(getattr(lp, n), n) for n in _ARRAYS})
            for lp in self.levels))

    def select_views(self, views: slice, num_views: int) -> "WindowPlan":
        """The plan of `views` (a slice of the rig's views) under view
        parallelism; the plan itself where it already holds `num_views`
        views. The rows keep the rig's padding, so each view's rows are
        the ones the rig's plan gives it."""
        if self.levels[0].row_query.shape[0] == num_views:
            return self
        return self._replace(levels=tuple(
            lp._replace(**{n: getattr(lp, n)[views] for n in _ARRAYS})
            for lp in self.levels))


def _dma_width(block_tile: np.ndarray, K: int, tile: int, ntx: int) -> int:
    """The 'pallas_dma' window width: each block's x origin is aligned down
    to a multiple of 8, so the window widens by the largest shift, rounded
    up to a multiple of 8."""
    ox = (block_tile % ntx) * tile + 2
    return -(-(K + int((ox % 8).max())) // 8) * 8


def build_window_plan(centers_px: np.ndarray,
                      spatial_shapes: Sequence[Tuple[int, int]],
                      tile: int = 8, halo: int = 10,
                      block_rows: Sequence[int] = None,
                      impl: str = "xla") -> WindowPlan:
    """Host-side plan: assign each (view, query, level) to a static tile.

    centers_px: (V, Lq, L, 2) static sampling centers in each level's
    pixel coordinates ((x, y), grid_sample convention: loc * size - 0.5),
    i.e. the layer-1 projected reference points WITHOUT learned offsets.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown window impl {impl!r}; one of {IMPLS}")
    V, Lq, L, _ = centers_px.shape
    if L != len(spatial_shapes):
        raise ValueError(f"{L} levels of centers, {len(spatial_shapes)} "
                         f"spatial shapes")
    pad = halo + 2
    K = tile + 2 * halo  # window side; covers offsets up to halo - 2
    plans = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        br = (block_rows[lvl] if block_rows is not None
              else (32 if h * w >= 16384 else (64 if h * w >= 4096
                                               else 128)))
        nty = -(-h // tile)
        ntx = -(-w // tile)
        n_tiles = nty * ntx
        rq, rv, ro, bt, ip = [], [], [], [], []
        for v in range(V):
            cx = centers_px[v, :, lvl, 0]
            cy = centers_px[v, :, lvl, 1]
            tx = np.clip(np.floor(cx / tile).astype(np.int64), 0, ntx - 1)
            ty = np.clip(np.floor(cy / tile).astype(np.int64), 0, nty - 1)
            tid = ty * ntx + tx
            order = np.argsort(tid, kind="stable")
            # pad each tile's run to a multiple of block_rows; real rows
            # are the head of each run, pads (query 0, valid 0) the tail
            rows_q, rows_t, rows_v = [], [], []
            pos = np.full(Lq, -1, np.int64)
            sorted_tid = tid[order]
            starts = np.searchsorted(sorted_tid, np.arange(n_tiles),
                                     side="left")
            ends = np.searchsorted(sorted_tid, np.arange(n_tiles),
                                   side="right")
            n_sofar = 0
            for t in range(n_tiles):
                qs = order[starts[t]:ends[t]]
                if qs.size == 0:
                    continue
                n_pad = (-qs.size) % br
                pos[qs] = n_sofar + np.arange(qs.size)
                rows_q.append(np.concatenate(
                    [qs, np.zeros(n_pad, np.int64)]))
                rows_v.append(np.concatenate(
                    [np.ones(qs.size, np.float32),
                     np.zeros(n_pad, np.float32)]))
                rows_t.append(np.full(qs.size + n_pad, t, np.int64))
                n_sofar += qs.size + n_pad
            rows_q = np.concatenate(rows_q)
            rows_t = np.concatenate(rows_t)
            valid = np.concatenate(rows_v)
            assert (pos >= 0).all()
            origin_x = (rows_t % ntx) * tile - halo + pad
            origin_y = (rows_t // ntx) * tile - halo + pad
            rq.append(rows_q)
            rv.append(valid)
            ro.append(np.stack([origin_x, origin_y], -1))
            bt.append(rows_t.reshape(-1, br)[:, 0])
            ip.append(pos)
        # per-view row counts differ; pad to the max with dummy rows on
        # tile 0
        n_rows = max(x.size for x in rq)
        n_rows = -(-n_rows // br) * br

        def padv(a, fill, shape_tail=()):
            out = np.full((V, n_rows) + shape_tail, fill, a[0].dtype)
            for v in range(V):
                out[v, :a[v].shape[0]] = a[v]
            return out

        row_query = padv(rq, 0)
        row_valid = padv(rv, 0.0)
        row_origin = padv([o.astype(np.int64) for o in ro], pad, (2,))
        nblocks = n_rows // br
        block_tile = np.zeros((V, nblocks), np.int64)
        for v in range(V):
            nb = bt[v].shape[0]
            block_tile[v, :nb] = bt[v]
        inv_perm = np.stack(ip)
        plans.append(LevelPlan(
            K=K, tile=tile, pad=pad, block_rows=br,
            row_query=row_query.astype(np.int32),
            row_valid=row_valid.astype(np.float32),
            row_origin=row_origin.astype(np.int32),
            block_tile=block_tile.astype(np.int32),
            inv_perm=inv_perm.astype(np.int32),
            n_tiles=n_tiles, grid_hw=(nty, ntx),
            Kx=_dma_width(block_tile, K, tile, ntx)))
    return WindowPlan(levels=tuple(plans), halo=halo, impl=impl)


def _tile_windows(v_map: torch.Tensor, plan: LevelPlan) -> torch.Tensor:
    """(..., h, w, H, D) level maps -> (..., n_tiles, K*K, H, D) halo'd
    windows: window (ty, tx) starts at (ty*tile + 2, tx*tile + 2) of the
    map zero-padded by (pad, pad + tile) on each spatial axis."""
    *lead, h, w, H, D = v_map.shape
    K, tile, pad = plan.K, plan.tile, plan.pad
    nty, ntx = plan.grid_hw
    x = v_map.reshape(-1, h, w, H * D)
    p = F.pad(x, (0, 0, pad, pad + tile, pad, pad + tile))
    # (n, nty', ntx', C, K, K) from offset 2 in steps of `tile`
    win = p[:, 2:, 2:].unfold(1, K, tile).unfold(2, K, tile)
    win = win[:, :nty, :ntx].permute(0, 1, 2, 4, 5, 3)
    return win.reshape(*lead, nty * ntx, K * K, H, D)


def _inside_mass(rx, ry, kx, ky):
    """Closed-form in-window bilinear mass per sample (the integer triangle
    kernel is a partition of unity, so the mass inside [0, k-1] per axis is
    the product of the two edge-clipped axis masses). kx/ky are the window
    extents in x/y (they differ for 'pallas_dma', whose x extent is Kx)."""
    mx = torch.clamp(rx + 1.0, 0.0, 1.0) * torch.clamp(kx - rx, 0.0, 1.0)
    my = torch.clamp(ry + 1.0, 0.0, 1.0) * torch.clamp(ky - ry, 0.0, 1.0)
    return mx * my


class LevelCall(NamedTuple):
    """One level's kernel call: `fn(*args, **kwargs)` gives its (V*nrows,
    H*D) rows in tile-sorted order; `inv_perm` (V, Lq) puts them back in
    query order."""

    fn: Callable
    args: tuple
    kwargs: dict
    escaped: torch.Tensor
    inv_perm: torch.Tensor


def level_calls(value: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]],
                sampling_locations: torch.Tensor,
                attention_weights: torch.Tensor,
                plan: WindowPlan,
                row_dtype: torch.dtype = torch.bfloat16,
                impl: str = None) -> List[LevelCall]:
    """Pack each level's rows and windows for its window kernel; arguments
    as in `window_sample`."""
    V, Len_in, H, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    impl = plan.impl if impl is None else impl
    if impl not in IMPLS:
        raise ValueError(f"unknown window impl {impl!r}; one of {IMPLS}")
    if L != len(spatial_shapes) or L != len(plan.levels):
        raise ValueError(f"{L} levels of locations, {len(spatial_shapes)} "
                         f"spatial shapes, {len(plan.levels)} plan levels")
    dev = value.device
    plan_v = plan.levels[0].row_query.shape[0]
    # the caller folded (views, batch) view-major (n = v*B + b); the plan
    # is per view, so each view's tables repeat B times
    B = V // plan_v
    if plan_v * B != V:
        raise ValueError(f"{V} folded views for a plan of {plan_v} views")

    def table(a, dtype):
        t = torch.as_tensor(a, device=dev).to(dtype)
        return t if B == 1 else t.repeat_interleave(B, dim=0)

    vix = torch.arange(V, device=dev)
    calls, start = [], 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        lp = plan.levels[lvl]
        K, pad, nty, ntx = lp.K, lp.pad, lp.grid_hw[0], lp.grid_hw[1]
        rq = table(lp.row_query, torch.long)          # (V, nrows)
        rvalid = table(lp.row_valid, torch.float32)
        rorig = table(lp.row_origin, torch.long)      # (V, nrows, 2)
        btile = table(lp.block_tile, torch.long)      # (V, nblocks)
        iperm = table(lp.inv_perm, torch.long)        # (V, Lq)
        nrows = rq.shape[1]
        v_lvl = value[:, start:start + h * w].reshape(V, h, w, H, D)
        start += h * w

        loc = sampling_locations[:, :, :, lvl].float()  # (V, Lq, H, P, 2)
        aw = attention_weights[:, :, :, lvl].float()    # (V, Lq, H, P)
        # px coords in PADDED space
        px = loc[..., 0] * w - 0.5 + pad
        py = loc[..., 1] * h - 0.5 + pad
        if impl == "pallas_dma":
            # x origins aligned down to 8 and the window widened to Kx;
            # rx is relative to the aligned origin
            Kx = lp.Kx
            ox = (rorig[..., 0] // 8) * 8
        else:
            Kx = K
            ox = rorig[..., 0]
        px_r = px[vix[:, None], rq]                       # (V, nrows, H, P)
        py_r = py[vix[:, None], rq]
        rx = px_r - ox[:, :, None, None].float()
        ry = py_r - rorig[..., 1][:, :, None, None].float()
        ra = aw[vix[:, None], rq] * rvalid[:, :, None, None]
        # escape telemetry counts only samples whose stencil overlaps the
        # REAL map: off-map samples read zero in the exact sampler too
        touch = ((px_r > pad - 1.0) & (px_r < w + pad)
                 & (py_r > pad - 1.0) & (py_r < h + pad)).float()
        escaped = torch.sum(ra * touch * torch.clamp(
            1.0 - _inside_mass(rx, ry, Kx, K), min=0.0))
        rel = torch.cat([ry, rx, ra], dim=-1).reshape(V * nrows, H * 3 * P)
        sizes = dict(K=K, H=H, P=P, D=D, block_rows=lp.block_rows)

        if impl == "pallas_dma":
            # extra right padding in x covers the widened window
            padded = F.pad(v_lvl.reshape(V, h, w, H * D),
                           (0, 0, pad, pad + lp.tile + (Kx - K),
                            pad, pad + lp.tile))
            oy = (btile // ntx) * lp.tile + 2
            ox_blk = (((btile % ntx) * lp.tile + 2) // 8) * 8
            origins = torch.stack([vix[:, None].expand_as(oy), oy, ox_blk],
                                  dim=-1).reshape(-1, 3).int()
            calls.append(LevelCall(window_block_dma,
                                   (padded, rel, origins.contiguous()),
                                   dict(sizes, Kx=Kx), escaped, iperm))
            continue
        n_tiles = lp.n_tiles
        tiles = _tile_windows(v_lvl, lp).reshape(V * n_tiles, K * K, H * D)
        bt_flat = (btile + vix[:, None] * n_tiles).reshape(-1).int()
        fn = window_block_matmul
        if impl == "xla" and dev.type == "cpu":
            fn = functools.partial(window_block_matmul_plain,
                                   row_dtype=row_dtype)
        calls.append(LevelCall(fn, (tiles, rel, bt_flat), sizes, escaped,
                               iperm))
    return calls


def window_sample(value: torch.Tensor,
                  spatial_shapes: Sequence[Tuple[int, int]],
                  sampling_locations: torch.Tensor,
                  attention_weights: torch.Tensor,
                  plan: WindowPlan,
                  row_dtype: torch.dtype = torch.bfloat16,
                  impl: str = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Windowed deformable sampling; the contract of
    `ops/sampling.py::deform_sample` plus a telemetry scalar.

    value:              (V, Len_in, H, D)
    sampling_locations: (V, Lq, H, L, P, 2) in [0, 1]
    attention_weights:  (V, Lq, H, L, P)
    plan:               from `build_window_plan`, for V views or for V / B
                        views of a view-major (view, batch) fold
    row_dtype:          weight-row dtype of impl 'xla' on the CPU; the
                        kernels weight in float32
    impl:               overrides plan.impl
    Returns ((V, Lq, H*D) features in the dtype of value, summed over the
    levels in float32; the escaped attention mass, a float32 scalar).
    """
    V, _, H, D = value.shape
    Lq = sampling_locations.shape[1]
    out = torch.zeros((V, Lq, H * D), dtype=torch.float32,
                      device=value.device)
    escaped = torch.zeros((), dtype=torch.float32, device=value.device)
    vix = torch.arange(V, device=value.device)[:, None]
    for call in level_calls(value, spatial_shapes, sampling_locations,
                            attention_weights, plan, row_dtype, impl):
        rows = call.fn(*call.args, **call.kwargs).reshape(V, -1, H * D)
        out += rows[vix, call.inv_perm].float()
        escaped = escaped + call.escaped
    return out.to(value.dtype), escaped
