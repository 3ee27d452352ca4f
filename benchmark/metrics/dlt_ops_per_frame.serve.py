"""Device operations per served frame launched inside the Jacobi DLT's
span (`mvg.dlt`: the inverse affine, the undistortion, the softmax over
views, the solve and the masked update of each DQ layer; geometry/
triangulate.py, geometry/cameras.py), from the traced window's spans
(`benchmark/spans.py`). Left out where the span did not run (MvP) or the
record holds no spans."""

from benchmark import spans


def read(record: dict):
    return spans.ops_per_unit(record, "mvg.dlt", "frame")
