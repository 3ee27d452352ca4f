"""The per-view feature volumes the volumetric Learnable Triangulation
model sampled per served frame, one a view: the port's counter
`volumetric.view_volumes` (`utils/profiling.py::COUNTERS`, counted by
`models/volumetric.py` from shapes the host knows) moved by the traced
frames (`record["counters"]`). Left out where it did not move (the other
models)."""


def read(record: dict):
    volumes = record.get("counters", {}).get("volumetric.view_volumes", 0)
    if not volumes or not record.get("frames"):
        return None
    return volumes / record["frames"]
