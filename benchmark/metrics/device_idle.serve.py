"""The device's idle share of a served frame, in %: 1 - (the device's busy
seconds per frame in the traced window) / (the wall seconds per frame of
the same run's untraced window). The profiler slows the host but not the
device's work, so the busy time is read from the trace and the wall time
from the untraced window."""


def read(record: dict):
    busy = record["busy_s"] / record["frames"]
    return 100.0 * (1.0 - busy / record["frame_s"])
