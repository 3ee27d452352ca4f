"""The parts of the sorted-window gather of
tools/probes/probe_sorted_gather_parts.py, on the card.

The TPU probe measured what a sorted-window gather of B3 would cost at the
dense layer-1 shape: 40 (view, head) pairs x 184,320 samples (15360
queries x 4 points x 3 levels) of production-like rows (queries uniform
over the 128 x 240 level-0 map, points within a normal 4 px of them, rows
y * 242 + x) from 41,620 concatenated table rows of 128 bfloat16 channels.
Its parts, here:

    sort      torch.sort of the (40, 184320) int32 rows with their slots
              (lax.sort_key_val), and torch.argsort
    spans     the row span of blocks of BS sorted samples, BS 512 / 1024 /
              2048: p50, p95, max
    window    one pair's windowed select over its sorted rows, BS = 1024,
              W = 512, window origins floor8(first row) capped at R - W,
              escapes clamped into the window (the Pallas kernel at :142)
              -> ops/gather_forms.py::window_gather, unit 1; its plain
              version stands for the probe's pure-XLA one-hot
    gather    the row gather of one pair and of all 40, on sorted and on
              unsorted rows -> ::row_gather

Library calls beside each kernel: torch.index_select of the same rows.

    python -m mvgformer_tpu_torch.tools.probes.probe_sorted_gather_parts \
        [part ...]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from mvgformer_tpu_torch.ops import gather_forms
from mvgformer_tpu_torch.tools.probes._common import Probe, parse_args
from mvgformer_tpu_torch.tools.probes.probe_pallas_gather import (
    run_row_gather)

NH, LQ, P = 40, 15360, 4
S = 3 * LQ * P  # samples per pair, all levels
R, C = 41620, 128  # concatenated corner-table rows
TOY_NH, TOY_S = 2, 4096
BS, W = 1024, 512
SPAN_BS = (512, 1024, 2048)
PARTS = ("sort", "spans", "window", "gather")


def production_like_indices(rng: np.random.Generator, nh: int, s: int,
                            points: int = P) -> np.ndarray:
    """(nh, s) int32 rows with production locality: queries uniform over
    the image, `points` points within a normal 4 px of each, row
    y * 242 + x on the (130, 242) level-0 padded grid."""
    q = s // points
    qy = rng.uniform(0, 128, (nh, q, 1))
    qx = rng.uniform(0, 240, (nh, q, 1))
    off = rng.standard_normal((nh, q, points, 2)) * 4.0
    y = np.clip(qy + off[..., 0], 0, 129).astype(np.int32)
    x = np.clip(qx + off[..., 1], 0, 241).astype(np.int32)
    return (y * 242 + x).reshape(nh, s)


def sorted_windows(sorted_rows: torch.Tensor, bs: int, w: int, r: int):
    """Per block of bs sorted rows: the window origin floor8(first row),
    capped at r - w, and each row's offset in it, clamped into [0, w)."""
    blocks = sorted_rows.reshape(-1, bs)
    base = torch.clamp((blocks[:, 0] // 8) * 8, max=r - w)
    local = torch.clamp(blocks - base[:, None], 0, w - 1)
    return base.to(torch.int32), local.reshape(-1).to(torch.int32)


def main(argv=None, device="cuda"):
    args = parse_args(argv, __doc__, device, PARTS)
    probe = Probe(args)
    nh, s = (TOY_NH, TOY_S) if args.toy else (NH, S)
    idx = probe.put(production_like_indices(probe.rng, nh, s))
    sorted_rows = torch.sort(idx, dim=-1).values
    table = probe.table((R, C), torch.bfloat16)
    for part in args.variants:
        if part == "sort":
            # lax.sort_key_val(idx, slots): torch.sort's indices are the
            # permuted slots
            probe.report("sort_key_val", shape=[nh, s], library="torch.sort",
                         library_ms=probe.ms(lambda: torch.sort(idx, dim=-1)))
            probe.report("argsort", shape=[nh, s], library="torch.argsort",
                         library_ms=probe.ms(lambda: torch.argsort(
                             idx, dim=-1)))
        elif part == "spans":
            for bs in SPAN_BS:
                blocks = sorted_rows.reshape(nh, -1, bs)
                span = (blocks[:, :, -1] - blocks[:, :, 0]).cpu().numpy()
                probe.report(f"sorted_block_span_BS{bs}",
                             p50=float(np.percentile(span, 50)),
                             p95=float(np.percentile(span, 95)),
                             max=int(span.max()))
        elif part == "window":
            run_window(probe, table, sorted_rows[0].contiguous())
        else:
            run_row_gather(probe, "gather_1pair_sorted", table,
                           sorted_rows[0].contiguous())
            run_row_gather(probe, "gather_1pair_unsorted", table,
                           idx[0].contiguous())
            tables = probe.table((nh, R, C), torch.bfloat16)
            run_row_gather(probe, f"gather_{nh}pairs_sorted", tables,
                           sorted_rows.contiguous())
            run_row_gather(probe, f"gather_{nh}pairs_unsorted", tables, idx)
            del tables
    return probe.results


def run_window(probe: Probe, table: torch.Tensor,
               sorted_rows: torch.Tensor) -> dict:
    """One pair's windowed select (BS, W) over its sorted rows, against its
    plain version, beside torch.index_select of the rows it reads."""
    base, local = sorted_windows(sorted_rows, BS, W, table.shape[0])
    tbl, base, local = table[None], base[None], local[None]
    out = gather_forms.window_gather(tbl, base, local, W, 1)
    probe.check("window", out, gather_forms.window_gather_plain(
        tbl, base, local, W, 1))
    del out
    rows = gather_forms.window_rows(base, local, W, 1)[0][0]
    escaped = int((sorted_rows != rows).sum())
    return probe.report(
        f"window_BS{BS}_W{W}_1pair", kernel=gather_forms.window_gather,
        rows=local.numel(), escaped_clamped=escaped,
        ms=probe.ms(lambda: gather_forms.window_gather(tbl, base, local, W,
                                                       1)),
        plain_ms=probe.ms(lambda: gather_forms.window_gather_plain(
            tbl, base, local, W, 1)),
        library_ms=probe.ms(lambda: torch.index_select(table, 0, rows)),
        library="torch.index_select")


if __name__ == "__main__":
    main(sys.argv[1:])
