"""The six gather forms of tools/probes/probe_mosaic_gather_forms.py, on the
card.

The TPU probe asked which Pallas gather forms its compiler lowers at all,
on a (2048, 128) float32 table and 512 indices:

    f1  take_along_axis axis 0, (512, 128) indices     -> take_along
    f2  jnp.take of 512 rows                            -> row_gather
    f3  lax.gather of 512 rows (collapsed dim 0)        -> row_gather
    f4  take_along_axis axis 0 on an (8, 128) table     -> take_along
    f5  take_along_axis axis 1 on a (128, 128) table    -> take_along
    f6  8 dynamic row slices                            -> row_gather

(ops/gather_forms.py). Each form is held against its plain version, bit
for bit, and timed beside the library call of the same function.

    python -m mvgformer_tpu_torch.tools.probes.probe_mosaic_gather_forms \
        [form ...]
"""

from __future__ import annotations

import sys

import torch

from mvgformer_tpu_torch.tools.probes._common import Probe, parse_args
from mvgformer_tpu_torch.tools.probes.probe_pallas_gather import (
    run_row_gather, run_take_along)

R, BLK, C = 2048, 512, 128
TOY_R, TOY_BLK = 64, 32
FORMS = ("f1_take_along_2d", "f2_take_1d", "f3_lax_gather",
         "f4_take_along_8row", "f5_take_along_lanes", "f6_dynslice_unroll8")


def main(argv=None, device="cuda"):
    args = parse_args(argv, __doc__, device, FORMS)
    probe = Probe(args)
    rows, blk = (TOY_R, TOY_BLK) if args.toy else (R, BLK)
    tbl = probe.table((rows, C), torch.float32)
    idx = probe.ints(0, rows, (blk,))
    for name in args.variants:
        if name == "f1_take_along_2d":
            run_take_along(probe, name, tbl,
                           idx[:, None].expand(blk, C).contiguous(), 0)
        elif name in ("f2_take_1d", "f3_lax_gather"):
            run_row_gather(probe, name, tbl, idx)
        elif name == "f4_take_along_8row":
            run_take_along(probe, name, probe.table((8, C), torch.float32),
                           probe.ints(0, 8, (8, C)), 0)
        elif name == "f5_take_along_lanes":
            run_take_along(probe, name, probe.table((C, C), torch.float32),
                           probe.ints(0, C, (C, C)), 1)
        else:
            run_row_gather(probe, name, tbl, idx[:8].contiguous())
    return probe.results


if __name__ == "__main__":
    main(sys.argv[1:])
