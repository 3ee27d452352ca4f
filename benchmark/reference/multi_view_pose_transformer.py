"""The reference frame of the MvP family (TRANSFORMER
multi_view_pose_transformer)."""

from benchmark.reference.model import mvp_frame as frame  # noqa: F401
