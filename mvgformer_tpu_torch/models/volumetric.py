"""The volumetric Learnable Triangulation model on the port's serving path.

Iskakov, Burkov, Lempitsky and Malkov, "Learnable Triangulation of Human
Pose" (ICCV 2019, arXiv:1905.05754); the published code is
karfly/learnable-triangulation-pose, class `VolumetricTriangulationNet` in
`mvn/models/triangulation.py`, whose Human3.6M setting is
`experiments/human36m/eval/human36m_vol_softmax.yaml`. A frame of B
synchronized sets of V views:

  * the trunk: PoseResNet on every view, its heatmaps (the last
    deconvolution's BN and ReLU, then `final_layer`, a 1x1 convolution to
    NETWORK.NUM_JOINTS maps) and the features the head reads;
    `process_features`, a 1x1 convolution with bias, cuts the features to
    NETWORK.VOLUME_FEATURES channels;
  * the cube: PICT_STRUCT.CUBE_SIZE points per axis spanning
    PICT_STRUCT.GRID_SIZE mm around a base point, at `position + side /
    (bins - 1) x i` with `position = base - side / 2`, axes x, y, z in the
    meshgrid's 'ij' order; no rotation (the published eval's angle is 0);
  * the unprojection (`unproject`): every cube point projected into every
    view's heatmap frame, mapped to `2 (u / size - 0.5)` (the published
    divides by the size, not by size - 1, under `align_corners=True`, and
    divides x by the heatmaps' height and y by their width: one number on
    its square maps), sampled bilinearly with zero padding over the
    processed channels, zero where the point's depth is not positive;
  * the aggregation: a softmax over the views of every (channel, voxel)
    entry, zeros included, and the sum of the views' entries under it (the
    published `volume_aggregation_method` 'softmax' of this setting, the
    only one the port runs);
  * `V2VModel(VOLUME_FEATURES, J)` over the aggregated volume;
  * the output: a softmax over the voxels of each joint's volume times
    NETWORK.BETA (the published `volume_multiplier`), and the expected
    cube point under it.

The pred is (B, 1, J, 5) = xyz | (score > threshold) - 1 | score, with a
score of 1.0: one subject a frame, as the published model gives.

Departures from the published code:

  * The base point (NETWORK.BASE_JOINT, the pelvis) is triangulated in the
    step from the trunk's own heatmaps: a 2D soft-argmax of that joint's
    heatmap times NETWORK.HEATMAP_MULTIPLIER in every view, scaled to
    network pixels, and the DLT over the views with equal weights
    (`ops/dlt_jacobi.py::fused_dlt`: the card's kernel, the plain chain on
    the CPU). The published evaluation reads the base point from a file of
    the algebraic model's predictions. The DLT's solve is the port's: the
    column-scaled Gram matrix with fixed Jacobi sweeps, where the paper's
    algebraic model takes an unscaled SVD; the two give other
    least-squares points where the rays do not meet.
  * The cube is projected through the rig's distortion model and crop
    affine into the heatmaps, as VoxelPose's path projects
    (`models/voxelpose.py::sample_volume`): the published projects with a
    pinhole matrix into images that its dataset undistorted first, the same
    sampling. The pelvis's 2D points go back through the inverse affine
    and the undistortion that `fused_dlt` applies.
  * The crop is the full image, not the subject's box.
  * The V views and B frames are sampled in one `grid_sample`, and the
    cube's coordinates are tensors: the published loops over frames and
    views in Python. The step makes no host synchronization.
  * The expected point is summed axis by axis over the softmax's marginals
    (the cube is the product of its three axes; VoxelPose's
    `models/voxelpose.py::soft_argmax`), where the published sums over the
    voxels in one product.
  * Serving only: no losses, no training.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mvgformer_tpu_torch.config import Config
from mvgformer_tpu_torch.data.meta import Batch, ViewData
from mvgformer_tpu_torch.device import constant, resolve_device
from mvgformer_tpu_torch.geometry.cameras import (camera_to_pixels,
                                                  projection_matrices,
                                                  world_to_camera)
from mvgformer_tpu_torch.geometry.transforms import apply_affine
from mvgformer_tpu_torch.models.mlp import init_linear_
from mvgformer_tpu_torch.models.pose_resnet import PoseResNet
from mvgformer_tpu_torch.models.v2v import V2VModel
from mvgformer_tpu_torch.models.voxelpose import grid_of, soft_argmax
from mvgformer_tpu_torch.ops.dlt_jacobi import fused_dlt
from mvgformer_tpu_torch.utils.profiling import count, span

# the V2V's five pools halve each side five times
POOLED = 32
VIEW_VOLUMES = "volumetric.view_volumes"


def soft_argmax_2d(heatmaps: torch.Tensor, multiplier: float
                   ) -> torch.Tensor:
    """(N, 2) x, y in heatmap pixels: the expected pixel under the softmax
    over each map (N, h, w) times `multiplier`, the published
    `integrate_tensor_2d`."""
    N, h, w = heatmaps.shape
    prob = F.softmax(multiplier * heatmaps.reshape(N, h * w), dim=-1)
    prob = prob.reshape(N, h, w)
    xs = torch.arange(w, dtype=prob.dtype, device=prob.device)
    ys = torch.arange(h, dtype=prob.dtype, device=prob.device)
    return torch.stack([(prob.sum(dim=1) * xs).sum(-1),
                        (prob.sum(dim=2) * ys).sum(-1)], dim=-1)


def cube_axes(base: torch.Tensor, sides: Sequence[float],
              bins: Sequence[int]) -> List[torch.Tensor]:
    """The x, y and z coordinates (B, bins[a]) mm of the cube around each
    base point (B, 3): `position + side / (bins - 1) x i`, `position =
    base - side / 2`."""
    return [base[:, a, None] - sides[a] / 2.0
            + (sides[a] / (bins[a] - 1)) * torch.arange(
                bins[a], dtype=base.dtype, device=base.device)
            for a in range(3)]


def unproject(features: torch.Tensor, view_data: ViewData,
              points: torch.Tensor, image_size: Sequence[int]
              ) -> torch.Tensor:
    """(B, C, N): the features (B, V, C, h, w) of every view sampled at the
    projections of world points (B, N, 3), zero behind a camera, and
    aggregated by the softmax over the views."""
    B, V, C, h, w = features.shape
    N = points.shape[1]
    xcam = world_to_camera(points[:, None], view_data.cameras)  # (B,V,N,3)
    pix = camera_to_pixels(xcam, view_data.cameras)
    xy = apply_affine(pix, view_data.affine)  # network pixels
    W, H = image_size
    # heatmap pixels, then the published normalization: x by the maps'
    # height and y by their width, each by the size
    scale = constant((w / W, h / H), device=points.device)
    size = constant((float(h), float(w)), device=points.device)
    grid = 2.0 * (xy * scale / size - 0.5)
    got = F.grid_sample(features.reshape(B * V, C, h, w),
                        grid.reshape(B * V, 1, N, 2), mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    volumes = torch.where(xcam[:, :, None, :, 2] > 0.0,
                          got.reshape(B, V, C, N), 0.0)
    return (volumes * F.softmax(volumes, dim=1)).sum(dim=1)


class VolumetricTriangulation(nn.Module):
    """Learnable Triangulation's volumetric serving model. Call with a
    Batch and the threshold; returns (poses (B, 1, J, 3) mm, scores (B, 1)
    of 1.0).

    The weights are drawn on the CPU from `generator` and moved to
    `device`, the card unless the caller asks for the CPU."""

    def __init__(self, cfg: Config,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        net = cfg.NETWORK
        J = net.NUM_JOINTS
        if cfg.PARALLEL.COMPUTE_DTYPE != "float32":
            raise ValueError("the volumetric model runs in float32, as "
                             "published")
        if (cfg.DECODER.num_keypoints, cfg.DECODER.num_instance) != (J, 1):
            raise ValueError(
                f"the served pred has DECODER.num_instance x "
                f"DECODER.num_keypoints rows: set them to 1 and "
                f"NETWORK.NUM_JOINTS ({J})")
        if any(b % POOLED for b in cfg.PICT_STRUCT.CUBE_SIZE):
            raise ValueError(f"PICT_STRUCT.CUBE_SIZE "
                             f"{cfg.PICT_STRUCT.CUBE_SIZE}: each side a "
                             f"multiple of {POOLED}, for the V2V's pools")
        if not 0 <= net.BASE_JOINT < J:
            raise ValueError(f"NETWORK.BASE_JOINT {net.BASE_JOINT} is not "
                             f"one of the {J} joints")
        self.cfg = cfg
        filters = tuple(cfg.POSE_RESNET.NUM_DECONV_FILTERS)
        self.backbone = PoseResNet(cfg.POSE_RESNET.NUM_LAYERS, filters,
                                   generator=generator, heatmap_joints=J)
        self.process_features = nn.Sequential(
            nn.Conv2d(filters[-1], net.VOLUME_FEATURES, 1))
        init_linear_(self.process_features[0].weight, "lecun", generator)
        with torch.no_grad():
            self.process_features[0].bias.zero_()
        self.volume_net = V2VModel(net.VOLUME_FEATURES, J,
                                   generator=generator)
        self.to(device)

    def pelvis(self, heatmaps: torch.Tensor, view_data: ViewData,
               image_size: Sequence[int]) -> torch.Tensor:
        """(B, 3) mm: the base joint triangulated from its heatmaps
        (B, V, h, w), the 2D soft-argmax scaled to network pixels and the
        DLT over the views with equal weights, inside the DQ decoder's DLT
        span (`mvg.dlt`)."""
        B, V, h, w = heatmaps.shape
        xy = soft_argmax_2d(heatmaps.reshape(B * V, h, w),
                            self.cfg.NETWORK.HEATMAP_MULTIPLIER)
        W, H = image_size
        xy = xy * constant((W / w, H / h), device=heatmaps.device)
        refined = xy.reshape(B, V, 1, 2).transpose(0, 1)  # (V, B, 1, 2)
        logits = torch.zeros((V, B, 1), device=heatmaps.device)
        mask = torch.ones((B, 1), dtype=torch.bool, device=heatmaps.device)
        proj = projection_matrices(view_data.cameras, inv_trans=True)
        with span("mvg.dlt"):
            return fused_dlt(refined, logits, mask, view_data.inv_affine,
                             view_data.cameras, proj)[:, 0]

    def forward(self, batch: Batch, threshold: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        views, vd = batch.views, batch.view_data
        B, V = views.shape[:2]
        image = cfg.NETWORK.IMAGE_SIZE
        bins = tuple(cfg.PICT_STRUCT.CUBE_SIZE)
        with span("mvg.backbone"):
            hm, feats = self.backbone(
                views.reshape((B * V,) + views.shape[2:]),
                with_features=True)
        J, h, w = hm.shape[1:]
        with span("mvg.lt.pelvis"):
            base = self.pelvis(
                hm.reshape(B, V, J, h, w)[:, :, cfg.NETWORK.BASE_JOINT], vd,
                image)
        with span("mvg.lt.volume"):
            feats = self.process_features(feats)
            axes = cube_axes(base, cfg.PICT_STRUCT.GRID_SIZE, bins)
            cube = unproject(feats.reshape((B, V) + feats.shape[1:]), vd,
                             grid_of(axes), image)
        count(VIEW_VOLUMES, B * V)
        with span("mvg.lt.v2v"):
            volumes = self.volume_net(cube.reshape((B, -1) + bins))
        with span("mvg.lt.softargmax"):
            poses = soft_argmax(volumes, cfg.NETWORK.BETA, axes)
        scores = torch.ones((B, 1), dtype=poses.dtype, device=poses.device)
        return poses[:, None], scores
