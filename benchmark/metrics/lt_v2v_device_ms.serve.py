"""Device ms per served frame of the volumetric Learnable Triangulation
model's five-level V2V over the aggregated 64^3 feature cube (span
`mvg.lt.v2v`): the device seconds of the operations launched in the span
(`benchmark/spans.py`) over the traced frames. Left out where the span did
not run (the other models) or the record holds no spans."""

from benchmark import spans

SPAN = "mvg.lt.v2v"


def read(record: dict):
    entries = spans.spanned(record, SPAN)
    if len(entries) != 1 or not record.get("frames"):
        return None
    return 1e3 * entries[0]["device_s"] / record["frames"]
