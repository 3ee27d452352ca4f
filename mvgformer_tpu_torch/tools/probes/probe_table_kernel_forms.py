"""The corner-table forms of tools/probes/probe_table_kernel_forms.py, on the
card.

The TPU probe bisected its compiler's failure on B2's table build with
forms of one function, the padded 4-corner table (NH, (h + 2) * wpp, 4D)
of a (NH, h, w, D) level, wpp = round_up(w + 2, 16), for NH = 40, D = 32,
bfloat16, at (128, 240) and the small (16, 30):

    a, a_small  the shipped kernel, B2 itself
    b, b_small  a concatenating store              -> B2's table
    c, c_small  the same with prefetched origins   -> B2's table
    e, e_small  two row-offset block views         -> B2's table
    d0 .. d4    store patterns at (16, 30) -> ops/gather_forms.py::table_slots
                with the slot maps of SLOT_MAPS; d2 is B2's own map

Forms a, b, c and e run csrc/table_build.cu (ops/table_build.py), held bit
for bit against its plain version; d0-d4 run the same kernel with their
slot maps (ops/gather_forms.py::table_slots), held against its plain
version, and d2 also against B2. No single PyTorch call
builds these tables (a pad, four slices and a concatenation do), so no
library call is timed.

    python -m mvgformer_tpu_torch.tools.probes.probe_table_kernel_forms \
        [form ...]
"""

from __future__ import annotations

import sys

import torch

from mvgformer_tpu_torch.ops import gather_forms, table_build
from mvgformer_tpu_torch.tools.probes._common import Probe, parse_args

NH, D = 40, 32
SIZES = {"": (128, 240), "_small": (16, 30)}
TOY_NH, TOY_D, TOY_SIZES = 2, 8, {"": (16, 30), "_small": (4, 6)}
FORMS = tuple(f"{f}{s}" for f in "abce" for s in SIZES) + tuple(
    gather_forms.SLOT_MAPS)


def main(argv=None, device="cuda"):
    args = parse_args(argv, __doc__, device, FORMS)
    probe = Probe(args)
    nh, d, sizes = (TOY_NH, TOY_D, TOY_SIZES) if args.toy else (NH, D, SIZES)
    for name in args.variants:
        slots = gather_forms.SLOT_MAPS.get(name)
        h, w = sizes["_small" if slots is not None or name.endswith(
            "_small") else ""]
        v = probe.table((nh, h, w, d), torch.bfloat16)
        if slots is None:
            got = table_build.build_corner_table(v[:, None])
            probe.check(name, got, table_build.build_corner_table_plain(
                v[:, None]))
            probe.report(
                name, kernel=table_build.build_corner_table, shape=[nh, h, w,
                                                                    d],
                out=list(got.shape), sum=got.float().sum().item(),
                ms=probe.ms(lambda: table_build.build_corner_table(
                    v[:, None])),
                plain_ms=probe.ms(lambda: table_build.build_corner_table_plain(
                    v[:, None])), library_ms=None)
            continue
        got = gather_forms.table_slots(v, slots)
        probe.check(name, got, gather_forms.table_slots_plain(v, slots))
        equals_b2 = torch.equal(got, table_build.build_corner_table(
            v[:, None]))
        if (slots == gather_forms.B2_SLOTS) != equals_b2:
            raise RuntimeError(f"{name}: equal to B2's table is {equals_b2}")
        probe.report(
            name, kernel=gather_forms.table_slots, shape=[nh, h, w, d],
            slots=[list(s) if s else None for s in slots],
            equals_b2=equals_b2, out=list(got.shape),
            sum=got.float().sum().item(),
            ms=probe.ms(lambda: gather_forms.table_slots(v, slots)),
            plain_ms=probe.ms(lambda: gather_forms.table_slots_plain(
                v, slots)), library_ms=None)
    return probe.results


if __name__ == "__main__":
    main(sys.argv[1:])
