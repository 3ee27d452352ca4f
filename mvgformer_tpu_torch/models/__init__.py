"""Model layer: backbone, DQ decoder, MVGFormer top model, the MvP
baseline and the volumetric models (VoxelPose, Learnable Triangulation)."""

from __future__ import annotations

from typing import Optional

import torch

from mvgformer_tpu_torch.config import Config

# the cfg.TRANSFORMER values: the paper model, the MvP baseline and the
# volumetric models, VoxelPose and Learnable Triangulation's (serving only)
DQ_TRANSFORMER = "dq_transformer"
MVP_TRANSFORMER = "multi_view_pose_transformer"
VOXELPOSE = "voxelpose"
VOLUMETRIC_TRIANGULATION = "volumetric_triangulation"
# the models that give the served pred's poses and scores directly, which
# the port serves and does not train, by name
POSE_MODELS = {VOXELPOSE: "VoxelPose",
               VOLUMETRIC_TRIANGULATION: "the volumetric triangulation model"}


def build_model(cfg: Config, generator: Optional[torch.Generator] = None,
                device="cuda"):
    """The top model that cfg.TRANSFORMER selects, its weights drawn from
    `generator`, on `device` (the card unless the caller asks for the
    CPU)."""
    if cfg.TRANSFORMER == DQ_TRANSFORMER:
        from mvgformer_tpu_torch.models.mvgformer import MVGFormer

        return MVGFormer(cfg, generator=generator, device=device)
    if cfg.TRANSFORMER == MVP_TRANSFORMER:
        from mvgformer_tpu_torch.models.mvp_decoder import MvPTransformer

        return MvPTransformer(cfg, generator=generator, device=device)
    if cfg.TRANSFORMER == VOXELPOSE:
        from mvgformer_tpu_torch.models.voxelpose import VoxelPose

        return VoxelPose(cfg, generator=generator, device=device)
    if cfg.TRANSFORMER == VOLUMETRIC_TRIANGULATION:
        from mvgformer_tpu_torch.models.volumetric import (
            VolumetricTriangulation)

        return VolumetricTriangulation(cfg, generator=generator,
                                       device=device)
    raise ValueError(
        f"unknown TRANSFORMER {cfg.TRANSFORMER!r}; expected "
        f"{DQ_TRANSFORMER!r}, {MVP_TRANSFORMER!r}, {VOXELPOSE!r} or "
        f"{VOLUMETRIC_TRIANGULATION!r}")


def is_dq(cfg: Config) -> bool:
    """Whether cfg.TRANSFORMER selects the DQ model (MVGFormer), with an
    initial query grid to match on and a layer 1 that takes a window plan,
    rather than the MvP baseline."""
    return cfg.TRANSFORMER == DQ_TRANSFORMER


def serves_poses(cfg: Config) -> bool:
    """Whether cfg.TRANSFORMER selects a model that gives the served
    pred's poses and scores directly (`POSE_MODELS`)."""
    return cfg.TRANSFORMER in POSE_MODELS


def refuse_volumetric(cfg: Config, what: str) -> None:
    """Raise where `what` is asked of a model of `POSE_MODELS`, which the
    port serves only (`core/infer.py::make_eval_step`)."""
    if serves_poses(cfg):
        raise ValueError(f"{what}: the port serves "
                         f"{POSE_MODELS[cfg.TRANSFORMER]} only "
                         f"(make_eval_step), it does not train it")
