"""Launches of the Jacobi DLT's backward kernel per training step: the
port's counter `dlt_jacobi.backward_launches` (`utils/profiling.py::
COUNTERS`, counted by `ops/dlt_jacobi.py` at each backward launch) moved
by the traced steps (`record["counters"]`), over `record["steps"]`. One a
decoder layer a step: 4.0 on the four-layer configuration. Left out where
it did not move (a program whose training runs the plain chain, or that
has no such counter)."""


def read(record: dict):
    launches = record.get("counters", {}).get(
        "dlt_jacobi.backward_launches", 0)
    if not launches or not record.get("steps"):
        return None
    return launches / record["steps"]
