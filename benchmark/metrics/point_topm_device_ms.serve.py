"""Device ms per served frame of point-top-m in ProjAttn (span
`mvg.point_topm`, once per decoder layer: the selection of each (query,
head, level)'s heaviest sampling points): the device seconds of the
operations launched in the span (`benchmark/spans.py`) over the traced
frames. Left out where the span did not run (a model without point-top-m,
a program without the span) or the record holds no spans."""

from benchmark import spans

SPAN = "mvg.point_topm"


def read(record: dict):
    entries = spans.spanned(record, SPAN)
    if len(entries) != 1 or not record.get("frames"):
        return None
    return 1e3 * entries[0]["device_s"] / record["frames"]
