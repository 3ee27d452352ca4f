"""VoxelPose on the port's serving path.

Tu, Wang and Zeng, "VoxelPose: Towards Multi-Camera 3D Human Pose
Estimation in Wild Environment" (ECCV 2020, arXiv:2004.06239); the
published code is microsoft/voxelpose-pytorch, whose Panoptic setting is
`configs/panoptic/resnet50/prn64_cpn80x80x20_960x512_cam5.yaml`. A frame:

  * heatmaps: PoseResNet on every view, then its head (the last
    deconvolution's BN and ReLU, a 1x1 convolution to NETWORK.NUM_JOINTS
    maps at a quarter of the image size);
  * the cuboid proposal network (CPN): every centre of a
    MULTI_PERSON.INITIAL_CUBE_SIZE grid over the capture space
    (SPACE_SIZE around SPACE_CENTER) projected into every view with the
    distortion model and the crop affine, the heatmaps sampled bilinearly
    there (`align_corners=True`), the mean over the views whose full image
    holds the point, NaNs to 0, clamped to [0, 1] (`sample_volume`); then
    `V2VNet(J -> 1)` gives the root cube;
  * the proposals: a 3x3x3 max-pool NMS (a voxel keeps its value where it
    equals the pool's, else 0), the top MAX_PEOPLE_NUM voxels, their
    indices mapped to mm (index / (bins - 1) x size + centre - size / 2),
    valid where the score exceeds the threshold;
  * the pose regression network (PRN): a PICT_STRUCT.CUBE_SIZE grid over
    PICT_STRUCT.GRID_SIZE mm around each candidate's root, sampled as the
    CPN's, `V2VNet(J -> J)`, then a soft-argmax over the grid with
    NETWORK.BETA (softmax of beta x the volume, the expected grid point).

The pred is (B, MAX_PEOPLE_NUM, J, 5) = xyz | (score > threshold) - 1 |
score, in the published row order (descending root score); a row under the
threshold holds xyz 0, as the published pred (zeros, filled for valid
candidates only) does.

Departures from the published code:

  * The PRN runs once, on every candidate's volume batched, and the rows
    under the threshold are zeroed afterwards. The published loops over
    the candidates and asks the host `torch.sum(index) > 0` for each, ten
    synchronizations and ten PRN calls a frame; the rows come out the
    same, and the step keeps one shape and makes no host synchronization.
  * The heatmap size that normalizes the sampling grid is the heatmaps'
    own; the published reads NETWORK.HEATMAP_SIZE, which equals it in its
    configurations.
  * The soft-argmax's expected point is summed axis by axis over the
    softmax's marginals (the grid is the product of its three axes): the
    published sum over the 64^3 points in another order, without a
    (J, N) x (N, 3) product, which cuBLAS runs in ~8 ms a frame on the
    card against ~0.3 ms for the three marginals.
  * Serving only: no ground-truth matching of proposals, no losses.
  * `root_net` and `pose_net` are the published `root_net.v2v_net` and
    `pose_net.v2v_net`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mvgformer_tpu_torch.config import Config
from mvgformer_tpu_torch.data.meta import Batch, ViewData
from mvgformer_tpu_torch.device import constant, resolve_device
from mvgformer_tpu_torch.geometry.cameras import project_points
from mvgformer_tpu_torch.geometry.transforms import apply_affine
from mvgformer_tpu_torch.models.pose_resnet import PoseResNet
from mvgformer_tpu_torch.models.v2v import V2VNet
from mvgformer_tpu_torch.utils.profiling import count, span


def grid_axes(centers: torch.Tensor, size: Sequence[float],
              bins: Sequence[int]) -> List[torch.Tensor]:
    """The x, y and z coordinates (..., bins[a]) mm of a `bins` grid
    spanning `size` around each of `centers` (..., 3): linspace per axis
    plus the centre, as the published `compute_grid`."""
    return [torch.linspace(-size[a] / 2.0, size[a] / 2.0, bins[a],
                           device=centers.device) + centers[..., a, None]
            for a in range(3)]


def grid_points(centers: torch.Tensor, size: Sequence[float],
                bins: Sequence[int]) -> torch.Tensor:
    """(..., prod(bins), 3) mm: the points of the grid of `grid_axes`, x
    slowest and z fastest (the published meshgrid)."""
    return grid_of(grid_axes(centers, size, bins))


def grid_of(axes: Sequence[torch.Tensor]) -> torch.Tensor:
    """(..., X * Y * Z, 3): the points of the grid whose x, y and z
    coordinates are `axes` (..., X), (..., Y), (..., Z), x slowest and z
    fastest (a meshgrid's 'ij' order)."""
    lead = axes[0].shape[:-1]
    bins = tuple(a.shape[-1] for a in axes)
    points = []
    for a, axis in enumerate(axes):
        shape = [1, 1, 1]
        shape[a] = bins[a]
        points.append(axis.reshape(lead + tuple(shape)).expand(lead + bins))
    return torch.stack(points, dim=-1).reshape(lead + (-1, 3))


def soft_argmax(volumes: torch.Tensor, beta: float,
                axes: Sequence[torch.Tensor]) -> torch.Tensor:
    """(N, J, 3): the expected grid point under the softmax of beta x
    each volume (N, J, X, Y, Z) over its voxels, on the grid of `axes`
    (N, X), (N, Y), (N, Z), summed axis by axis over the softmax's
    marginals (the grid is the product of its axes)."""
    N, J = volumes.shape[:2]
    prob = F.softmax(beta * volumes.reshape(N, J, -1),
                     dim=-1).reshape(volumes.shape)
    return torch.stack([
        (prob.sum(dim=rest) * axis[:, None]).sum(-1)
        for rest, axis in zip(((3, 4), (2, 4), (2, 3)), axes)], -1)


def sample_volume(heatmaps: torch.Tensor, view_data: ViewData,
                  points: torch.Tensor, image_size: Sequence[int]
                  ) -> torch.Tensor:
    """(B, J, N): the heatmaps (B, V, J, h, w) of every view sampled at
    the projections of world points (B, N, 3), averaged over the views
    whose full image holds a point, NaNs to 0, clamped to [0, 1]."""
    B, V, J, h, w = heatmaps.shape
    N = points.shape[1]
    pix = project_points(points[:, None], view_data.cameras)  # (B, V, N, 2)
    wh = view_data.centers * 2.0  # the full images' (width, height)
    inside = ((pix >= 0.0) & (pix < wh[:, :, None])).all(-1)
    pix = torch.clamp(pix, min=-1.0)
    pix = torch.minimum(pix, wh.amax(-1)[:, :, None, None])
    xy = apply_affine(pix, view_data.affine)
    hm = constant((w, h), device=points.device)
    xy = xy * hm / constant(tuple(image_size), device=points.device)
    grid = torch.clamp(xy / (hm - 1.0) * 2.0 - 1.0, -1.1, 1.1)
    got = F.grid_sample(heatmaps.reshape(B * V, J, h, w),
                        grid.reshape(B * V, 1, N, 2), mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    mask = inside[:, :, None].to(got.dtype)  # (B, V, 1, N)
    cube = ((got.reshape(B, V, J, N) * mask).sum(dim=1)
            / (mask.sum(dim=1) + 1e-6))
    cube = torch.where(torch.isnan(cube), 0.0, cube)
    return cube.clamp(0.0, 1.0)


def propose(roots: torch.Tensor, k: int, size: Sequence[float],
            center: Sequence[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top `k` voxels of root cubes (B, X, Y, Z) over the capture
    space (`size` mm around `center`) after a 3x3x3 max-pool NMS: their
    scores (B, k), highest first, and their centres in mm (B, k, 3)."""
    B, X, Y, Z = roots.shape
    peak = F.max_pool3d(roots[:, None], 3, stride=1, padding=1)[:, 0]
    kept = (roots == peak).to(roots.dtype) * roots
    scores, index = kept.reshape(B, -1).topk(k)
    ijk = torch.stack([index // (Y * Z), (index % (Y * Z)) // Z, index % Z],
                      dim=-1)
    bins = constant((X, Y, Z), device=roots.device)
    size_t = constant(tuple(size), device=roots.device)
    loc = (ijk.float() / (bins - 1.0) * size_t
           + constant(tuple(center), device=roots.device) - size_t / 2.0)
    return scores, loc


class VoxelPose(nn.Module):
    """VoxelPose's serving model. Call with a Batch and the threshold;
    returns (poses (B, M, J, 3) mm, zero under the threshold; root scores
    (B, M)), M = MULTI_PERSON.MAX_PEOPLE_NUM candidates.

    The weights are drawn on the CPU from `generator` (the published
    init: N(0, 0.001) for the heatmap head and every 3D convolution) and
    moved to `device`, the card unless the caller asks for the CPU."""

    def __init__(self, cfg: Config,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        if cfg.PARALLEL.COMPUTE_DTYPE != "float32":
            raise ValueError("VoxelPose runs in float32, as published")
        J = cfg.NETWORK.NUM_JOINTS
        M = cfg.MULTI_PERSON.MAX_PEOPLE_NUM
        if (cfg.DECODER.num_keypoints, cfg.DECODER.num_instance) != (J, M):
            raise ValueError(
                f"the served pred has DECODER.num_instance x "
                f"DECODER.num_keypoints rows: set them to MAX_PEOPLE_NUM "
                f"({M}) and NETWORK.NUM_JOINTS ({J})")
        self.cfg = cfg
        self.num_joints, self.num_cand = J, M
        self.backbone = PoseResNet(cfg.POSE_RESNET.NUM_LAYERS,
                                   tuple(cfg.POSE_RESNET.NUM_DECONV_FILTERS),
                                   generator=generator, heatmap_joints=J)
        self.root_net = V2VNet(J, 1, generator=generator)
        self.pose_net = V2VNet(J, J, generator=generator)
        self.to(device)

    def forward(self, batch: Batch, threshold: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg, mp = self.cfg, self.cfg.MULTI_PERSON
        views, vd = batch.views, batch.view_data
        B, V = views.shape[:2]
        J, M = self.num_joints, self.num_cand
        image = cfg.NETWORK.IMAGE_SIZE
        with span("mvg.backbone"):
            hm = self.backbone(views.reshape((B * V,) + views.shape[2:]))
        hm = hm.reshape((B, V) + hm.shape[1:])
        root_bins = tuple(mp.INITIAL_CUBE_SIZE)
        with span("mvg.vp.volume"):
            space = constant(tuple(mp.SPACE_CENTER), device=views.device)
            points = grid_points(space, mp.SPACE_SIZE, root_bins)
            cubes = sample_volume(hm, vd, points[None].expand(B, -1, -1),
                                  image)
        with span("mvg.vp.cpn"):
            roots = self.root_net(cubes.reshape((B, J) + root_bins))[:, 0]
        count("voxelpose.root_volumes", B)
        with span("mvg.vp.propose"):
            scores, centers = propose(roots, M, mp.SPACE_SIZE,
                                      mp.SPACE_CENTER)
            valid = scores > threshold
        pose_bins = tuple(cfg.PICT_STRUCT.CUBE_SIZE)
        pose_size = cfg.PICT_STRUCT.GRID_SIZE
        with span("mvg.vp.volume"):
            grids = grid_points(centers, pose_size, pose_bins)  # (B, M, N, 3)
            N = grids.shape[2]
            cubes = sample_volume(hm, vd, grids.reshape(B, M * N, 3), image)
            cubes = cubes.reshape(B, J, M, N).transpose(1, 2).reshape(
                (B * M, J) + pose_bins)
        with span("mvg.vp.prn"):
            volumes = self.pose_net(cubes)
        count("voxelpose.prn_volumes", B * M)
        with span("mvg.vp.softargmax"):
            poses = soft_argmax(volumes, cfg.NETWORK.BETA, grid_axes(
                centers.reshape(B * M, 3), pose_size, pose_bins))
            poses = torch.where(valid[..., None, None],
                                poses.reshape(B, M, J, 3), 0.0)
        return poses, scores


def voxel_pred(poses: torch.Tensor, scores: torch.Tensor,
               threshold: float) -> torch.Tensor:
    """The served pred (B, M, J, 5) = xyz | (score > threshold) - 1 |
    score of VoxelPose's poses (B, M, J, 3) and root scores (B, M)."""
    score = scores[:, :, None, None].expand(poses.shape[:3] + (1,))
    flag = (score > threshold).to(poses.dtype) - 1.0
    return torch.cat([poses, flag, score], dim=-1)
