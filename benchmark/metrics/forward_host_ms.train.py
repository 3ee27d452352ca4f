"""Host ms per training step inside the model's training forward
(`mvg.forward`), on the untraced clock (`benchmark/spans.py::
per_unit_ms`). Left out where the record holds no spans."""

from benchmark import spans


def read(record: dict):
    return spans.per_unit_ms(record, "mvg.forward", "step")
