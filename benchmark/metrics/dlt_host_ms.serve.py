"""Host ms per served frame inside the Jacobi DLT's span (`mvg.dlt`):
its traced share of the window times the untraced seconds per frame
(`benchmark/spans.py::per_unit_ms`). Left out where the span did not run
(MvP) or the record holds no spans."""

from benchmark import spans


def read(record: dict):
    return spans.per_unit_ms(record, "mvg.dlt", "frame")
