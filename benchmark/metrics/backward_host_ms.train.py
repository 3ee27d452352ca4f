"""Host ms per training step inside the backward (`mvg.backward`: the
main thread's wait on autograd's engine, which runs the backward kernels'
launches and the layers' recompute), on the untraced clock
(`benchmark/spans.py::per_unit_ms`). Left out where the record holds no
spans."""

from benchmark import spans


def read(record: dict):
    return spans.per_unit_ms(record, "mvg.backward", "step")
