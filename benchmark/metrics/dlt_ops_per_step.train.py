"""Device operations per training step launched inside the Jacobi DLT's
span (`mvg.dlt`), in the forward and in the layers' recompute (remat)
inside the backward; the DLT's backward kernels are launched by autograd's
nodes outside any span. Left out where the span did not run or the record
holds no spans."""

from benchmark import spans


def read(record: dict):
    return spans.ops_per_unit(record, "mvg.dlt", "step")
