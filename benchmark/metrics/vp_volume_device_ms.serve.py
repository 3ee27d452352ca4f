"""Device ms per served frame of VoxelPose's two volume samplings (span
`mvg.vp.volume`, twice a frame: the 80x80x20 root grid and the ten 64^3
candidate grids projected into every view, the heatmaps sampled at each
voxel): the device seconds of the operations launched in the span
(`benchmark/spans.py`) over the traced frames. Left out where the span did
not run (the other models) or the record holds no spans."""

from benchmark import spans

SPAN = "mvg.vp.volume"


def read(record: dict):
    entries = spans.spanned(record, SPAN)
    if len(entries) != 1 or not record.get("frames"):
        return None
    return 1e3 * entries[0]["device_s"] / record["frames"]
