"""Row gathers at the shapes of tools/probes/probe_pallas_gather.py, on the
card.

The TPU probe compiled Pallas forms of `out[i] = tbl[idx[i]]` for
S = 30720 samples from a (2048 or 31488, 128) table: jnp.take
(make_take_kernel), take_along_axis with column-broadcast indices (its
take_eq form) and a one-hot matmul (make_onehot_kernel), against XLA's
gather. Here the take and the one-hot form are one kernel,
ops/gather_forms.py::row_gather (a one-hot product has one non-zero term per
output), take_eq is ::take_along on axis 0, and XLA's gather is the library
call torch.index_select (torch.gather for take_eq), timed as library_ms.
One more row is at B3's flagship level-0 shape: 40 pairs x 122,880 rows
from tables of 130 x 256 rows of 128 bfloat16 channels.

    python -m mvgformer_tpu_torch.tools.probes.probe_pallas_gather \
        [variant ...]
"""

from __future__ import annotations

import sys

import torch

from mvgformer_tpu_torch.ops import gather_forms
from mvgformer_tpu_torch.tools.probes._common import Probe, parse_args

S, C = 30720, 128
ROWS = {"small": 2048, "big": 31488}
FLAGSHIP = (40, 130 * 256, 122880)  # pairs, table rows, samples per pair
TOY_S, TOY_ROWS, TOY_FLAGSHIP = 256, {"small": 64, "big": 300}, (2, 320, 512)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
VARIANTS = tuple(
    [name for tag in ROWS for d in DTYPES
     for name in ([f"take_{tag}_{d}"]
                  + ([f"take_eq_{tag}_{d}"] if tag == "small" else []))]
    + ["flagship_bf16"])


def flat_rows(tbl: torch.Tensor, idx: torch.Tensor):
    """The (P * R, C) view of a (P, R, C) table and the rows of idx (P, S)
    in it: index_select's operands for the same gather."""
    P, R, C = tbl.shape
    off = torch.arange(P, device=idx.device, dtype=idx.dtype)[:, None] * R
    return tbl.reshape(P * R, C), (idx + off).reshape(-1)


def run_row_gather(probe: Probe, name: str, tbl: torch.Tensor,
                   idx: torch.Tensor, **fields) -> dict:
    """row_gather against its plain version, then timed beside
    torch.index_select of the same rows."""
    out = gather_forms.row_gather(tbl, idx)
    probe.check(name, out, gather_forms.row_gather_plain(tbl, idx))
    del out
    if tbl.dim() == 2:
        flat, rows = tbl, idx
    else:
        flat, rows = flat_rows(tbl, idx)
    return probe.report(
        name, kernel=gather_forms.row_gather, rows=idx.numel(),
        ms=probe.ms(lambda: gather_forms.row_gather(tbl, idx)),
        library_ms=probe.ms(lambda: torch.index_select(flat, 0, rows)),
        library="torch.index_select", **fields)


def run_take_along(probe: Probe, name: str, tbl: torch.Tensor,
                   idx: torch.Tensor, axis: int, **fields) -> dict:
    """take_along against its plain version, then timed beside
    torch.gather."""
    out = gather_forms.take_along(tbl, idx, axis)
    probe.check(name, out, gather_forms.take_along_plain(tbl, idx, axis))
    del out
    idx64 = idx.long()
    return probe.report(
        name, kernel=gather_forms.take_along, rows=idx.shape[0],
        ms=probe.ms(lambda: gather_forms.take_along(tbl, idx, axis)),
        library_ms=probe.ms(lambda: torch.gather(tbl, axis, idx64)),
        library="torch.gather", **fields)


def main(argv=None, device="cuda"):
    args = parse_args(argv, __doc__, device, VARIANTS)
    probe = Probe(args)
    samples = TOY_S if args.toy else S
    rows_of = TOY_ROWS if args.toy else ROWS
    for name in args.variants:
        if name == "flagship_bf16":
            P, R, n = TOY_FLAGSHIP if args.toy else FLAGSHIP
            tbl = probe.table((P, R, C), torch.bfloat16)
            idx = probe.ints(0, R, (P, n))
            run_row_gather(probe, name, tbl, idx, shape=[P, R, C, n])
            del tbl, idx
            continue
        tag, d = name.split("_")[-2:]
        rows = rows_of[tag]
        tbl = probe.table((rows, C), DTYPES[d])
        idx = probe.ints(0, rows, (samples,))
        if name.startswith("take_eq"):
            idx2d = idx[:, None].expand(samples, C).contiguous()
            run_take_along(probe, name, tbl, idx2d, 0,
                           shape=[rows, C, samples])
        else:
            run_row_gather(probe, name, tbl, idx, shape=[rows, C, samples])
    return probe.results


if __name__ == "__main__":
    main(sys.argv[1:])
