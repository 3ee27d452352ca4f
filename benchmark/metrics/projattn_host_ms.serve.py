"""Host ms per served frame inside ProjAttn (`mvg.projattn`: the
offsets, the weights, point-top-m's sort and the sampling kernel's
launch), on the untraced clock (`benchmark/spans.py::per_unit_ms`). Left
out where the record holds no spans."""

from benchmark import spans


def read(record: dict):
    return spans.per_unit_ms(record, "mvg.projattn", "frame")
