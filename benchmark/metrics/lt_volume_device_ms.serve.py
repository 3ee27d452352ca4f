"""Device ms per served frame of the volumetric Learnable Triangulation
model's feature cube (span `mvg.lt.volume`: `process_features`, the 64^3
cube around the triangulated pelvis projected into every view, the
processed features sampled at each point, the softmax over the views): the
device seconds of the operations launched in the span
(`benchmark/spans.py`) over the traced frames. Left out where the span did
not run (the other models) or the record holds no spans."""

from benchmark import spans

SPAN = "mvg.lt.volume"


def read(record: dict):
    entries = spans.spanned(record, SPAN)
    if len(entries) != 1 or not record.get("frames"):
        return None
    return 1e3 * entries[0]["device_s"] / record["frames"]
