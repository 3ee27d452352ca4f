"""Scale, take-along and row gather at the shapes of
tools/probes/probe_pallas_gather2.py, on the card.

The TPU probe's Pallas kernels, each with a (2048, 128) table and
S = 30720 samples in float32 and bfloat16:

    trivial_kernel   out = 2 * tbl          -> ops/gather_forms.py::scale
    take_eq_kernel   take_along_axis axis 0 with (S, 128) indices
                                            -> ::take_along
    onehot_kernel    a one-hot (S, 2048) @ (2048, 128) product over column
                     0 of the indices: the row gather -> ::row_gather

and XLA's gather from the small and the big (31488-row) table, which here
is the row gather kernel again, timed beside torch.index_select. The
library calls torch.mul, torch.gather and torch.index_select are timed as
library_ms.

    python -m mvgformer_tpu_torch.tools.probes.probe_pallas_gather2 \
        [variant ...]
"""

from __future__ import annotations

import sys

import torch

from mvgformer_tpu_torch.ops import gather_forms
from mvgformer_tpu_torch.tools.probes._common import Probe, parse_args
from mvgformer_tpu_torch.tools.probes.probe_pallas_gather import (
    DTYPES, run_row_gather, run_take_along)

S, C, ROWS, BIG = 30720, 128, 2048, 31488
TOY_S, TOY_ROWS, TOY_BIG = 256, 64, 300
FORMS = ("trivial", "take_eq", "onehot", "gather_big")
VARIANTS = tuple(f"{form}_{d}" for d in DTYPES for form in FORMS)


def main(argv=None, device="cuda"):
    args = parse_args(argv, __doc__, device, VARIANTS)
    probe = Probe(args)
    samples = TOY_S if args.toy else S
    for name in args.variants:
        form, d = name.rsplit("_", 1)
        rows = (TOY_BIG if args.toy else BIG) if form == "gather_big" else (
            TOY_ROWS if args.toy else ROWS)
        tbl = probe.table((rows, C), DTYPES[d])
        idx = probe.ints(0, rows, (samples,))
        shape = [rows, C, samples]
        if form == "trivial":
            out = gather_forms.scale(tbl, 2.0)
            probe.check(name, out, gather_forms.scale_plain(tbl, 2.0))
            probe.report(name, kernel=gather_forms.scale, shape=[rows, C],
                         ms=probe.ms(lambda: gather_forms.scale(tbl, 2.0)),
                         library_ms=probe.ms(lambda: torch.mul(tbl, 2.0)),
                         library="torch.mul")
        elif form == "take_eq":
            idx2d = idx[:, None].expand(samples, C).contiguous()
            run_take_along(probe, name, tbl, idx2d, 0, shape=shape)
        else:
            run_row_gather(probe, name, tbl, idx, shape=shape)
    return probe.results


if __name__ == "__main__":
    main(sys.argv[1:])
