"""The 64^3 pose volumes VoxelPose's pose regression network computed per
served frame: the port's counter `voxelpose.prn_volumes`
(`utils/profiling.py::COUNTERS`, counted by `models/voxelpose.py` from
shapes the host knows) moved by the traced frames (`record["counters"]`).
Left out where it did not move (the other models)."""


def read(record: dict):
    volumes = record.get("counters", {}).get("voxelpose.prn_volumes", 0)
    if not volumes or not record.get("frames"):
        return None
    return volumes / record["frames"]
