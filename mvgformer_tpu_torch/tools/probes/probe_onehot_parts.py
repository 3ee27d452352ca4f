"""The windowed select of tools/probes/probe_onehot_parts.py and B3's
composition, on the card.

The TPU probe took 40 (view, head) pairs of bfloat16 tables of 31460 rows
of 128 channels, 120 blocks of BS = 512 samples per pair, and a window of
W = 1024 rows at 8 * base8[p, b] per block, and timed its one-hot window
kernel (make_kernel; the production form is B3's _onehot_select) with the
window's DMA and the one-hot matmul each on or off. Here each variant is a
mode of ops/gather_forms.py::window_gather:

    select  DMA and matmul: row local[p, i] of the window     mode 'select'
    dma     DMA only: the window's first BS rows              mode 'copy'
    matmul  matmul of a stale window (no defined output)      mode 'zero'
    neither the grid's block I/O alone                        mode 'zero'

The TPU's stale-window variants have no defined output; here they write
zeros, so they time the store floor. Then B3's whole gather-reduce at the
same shapes, random rows and weights: its kernel
(ops/table_gather.py::gather_reduce_forward) against its plain version.
Library calls: torch.index_select of the same flat rows (torch.zeros for
the zero modes) and F.embedding_bag for B3 (utils/yardsticks.py).

    python -m mvgformer_tpu_torch.tools.probes.probe_onehot_parts [variant ...]
"""

from __future__ import annotations

import sys

import torch

from mvgformer_tpu_torch.ops import gather_forms, table_gather
from mvgformer_tpu_torch.tools.probes._common import Probe, parse_args
from mvgformer_tpu_torch.tools.probes.probe_pallas_gather import flat_rows
from mvgformer_tpu_torch.utils import yardsticks

NH, R, C, BS, W, NBLK = 40, 31460, 128, 512, 1024, 120
TOY = (2, 300, 16, 16, 32, 4)  # NH, R, C, BS, W, NBLK
MODES = {"select": "select", "dma": "copy", "matmul": "zero",
         "neither": "zero"}
VARIANTS = (*MODES, "composition")


def main(argv=None, device="cuda"):
    args = parse_args(argv, __doc__, device, VARIANTS)
    probe = Probe(args)
    nh, r, c, bs, w, nblk = TOY if args.toy else (NH, R, C, BS, W, NBLK)
    S = nblk * bs
    tables = probe.table((nh, r, c), torch.bfloat16)
    base8 = probe.ints(0, (r - w) // 8, (nh, nblk))
    local = probe.ints(0, w, (nh, S))
    for name in args.variants:
        if name == "composition":
            continue
        mode = MODES[name]
        out = gather_forms.window_gather(tables, base8, local, w, 8, mode)
        probe.check(name, out, gather_forms.window_gather_plain(
            tables, base8, local, w, 8, mode))
        del out
        if mode == "zero":
            library = ("torch.zeros", lambda: torch.zeros(
                (nh, S, c), dtype=tables.dtype, device=tables.device))
        else:
            flat, rows = flat_rows(tables, gather_forms.window_rows(
                base8, local, w, 8, mode)[0])
            library = ("torch.index_select",
                       lambda: torch.index_select(flat, 0, rows))
        probe.report(
            f"window_{name}", kernel=gather_forms.window_gather, rows=nh * S,
            mode=mode, shape=[nh, r, c, nblk, bs, w],
            ms=probe.ms(lambda: gather_forms.window_gather(
                tables, base8, local, w, 8, mode)),
            library_ms=probe.ms(library[1]), library=library[0])
    if "composition" in args.variants:
        run_composition(probe, tables, S)
    return probe.results


def run_composition(probe: Probe, tables: torch.Tensor, S: int) -> dict:
    """B3's forward kernel against its plain version at the probe's
    shapes (random rows, normal weights in the table dtype), beside
    F.embedding_bag."""
    nh, r, c = tables.shape
    idx = probe.ints(0, r, (nh, S))
    w4 = probe.put(probe.rng.standard_normal(
        (nh, S, 4), dtype="float32")).to(tables.dtype)
    out = table_gather.gather_reduce_forward(tables, idx, w4)
    want = table_gather.deform_gather_reduce_plain(tables.float(), idx,
                                                   w4.float())
    # float32 sums in another order, one bfloat16 rounding
    if not torch.allclose(out.float(), want, atol=2e-2, rtol=2e-2):
        raise RuntimeError("B3's gather-reduce differs from its plain "
                           "version")
    del out, want
    operands = yardsticks.embedding_bag_operands(tables, idx, w4)
    return probe.report(
        "composition",
        kernel=table_gather.gather_reduce_forward, rows=nh * S,
        shape=[nh, r, c, S],
        ms=probe.ms(lambda: table_gather.gather_reduce_forward(
            tables, idx, w4)),
        plain_ms=probe.ms(lambda: table_gather.deform_gather_reduce_plain(
            tables, idx, w4)),
        library_ms=probe.ms(lambda: yardsticks.embedding_bag_reduce(
            *operands, nh)),
        library="F.embedding_bag")


if __name__ == "__main__":
    main(sys.argv[1:])
