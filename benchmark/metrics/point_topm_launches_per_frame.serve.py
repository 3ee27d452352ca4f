"""Point-top-m kernel launches per served frame: the port's counter
`point_topm.launches` (`utils/profiling.py::COUNTERS`, counted by
`ops/point_topm.py` at each launch) moved by the traced frames
(`record["counters"]`). One a decoder layer a batch: 4.0 at batch 1 and
0.5 at batch 8 on the four-layer configuration. Left out where it did not
move (a model without point-top-m, a program without the counter)."""


def read(record: dict):
    launches = record.get("counters", {}).get("point_topm.launches", 0)
    if not launches or not record.get("frames"):
        return None
    return launches / record["frames"]
