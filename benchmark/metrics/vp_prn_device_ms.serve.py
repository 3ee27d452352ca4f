"""Device ms per served frame of VoxelPose's pose regression network, the
V2V over the ten candidates' 64^3 volumes in one batch (span
`mvg.vp.prn`): the device seconds of the operations launched in the span
(`benchmark/spans.py`) over the traced frames. Left out where the span did
not run (the other models) or the record holds no spans."""

from benchmark import spans

SPAN = "mvg.vp.prn"


def read(record: dict):
    entries = spans.spanned(record, SPAN)
    if len(entries) != 1 or not record.get("frames"):
        return None
    return 1e3 * entries[0]["device_s"] / record["frames"]
