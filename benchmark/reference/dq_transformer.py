"""The reference frame of the MVGFormer family (TRANSFORMER dq_transformer)."""

from benchmark.reference.model import dq_frame as frame  # noqa: F401
