"""Host ms per served frame inside the decoder layers (every
`mvg.layer<l>` span, inclusive: each layer's call and its bookkeeping), on
the untraced clock (`benchmark/spans.py::per_unit_ms`). Left out where
the record holds no spans."""

from benchmark import spans


def read(record: dict):
    return spans.per_unit_ms(record, "mvg.layer", "frame")
