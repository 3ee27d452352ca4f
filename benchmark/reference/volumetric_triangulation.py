"""The reference frame of the volumetric Learnable Triangulation model
(TRANSFORMER volumetric_triangulation), in float32 plain PyTorch.

It states the forward of karfly/learnable-triangulation-pose as published
(`mvn/models/triangulation.py::VolumetricTriangulationNet`,
`mvn/utils/op.py::unproject_heatmaps` and `integrate_tensor_2d` /
`integrate_tensor_3d_with_coordinates`, `mvn/models/v2v.py::V2VModel`) and
shares no code with the port: PoseResNet through `model.backbone` on one
view at a time, then the heatmap head (the last deconvolution's BN and
ReLU, the 1x1 `final_layer`) and `process_features` on the head's input;
the base joint's 2D soft-argmax in every view and the DQ reference's
confidence-weighted DLT (`geometry.triangulate`, a float64 SVD of the
column-scaled system) with equal weights; the cube built as the published
builds it, one frame at a time (a meshgrid of indices, `position + side /
(n - 1) x index`, turned by an angle of 0 about the base point); the
unprojection as the published loop, one frame and one view at a time;
the five-level V2V from the weights by name; the softmax over the voxels
and the expected coordinate as one product over them.

As in the port, the cube is projected through the rig's distortion model
and crop affine, and the base point comes from the step's own heatmaps
(`configs/ltvol_h36m4.json`, `assumed`). The weights are the port's state
dict by name; `net.p` says where to round (`precision.py`). The frame runs
under `products(net.p.tf32)`: both TF32 flags off for the float32
reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import geometry as G
from benchmark.reference import model
from benchmark.reference.precision import products
from benchmark.reference.voxelpose import conv3d, bn3d, res3d, up3d


def trunk(net: model.Net, images, s: dict):
    """PoseResNet's heatmaps (N, J, h, w) of (N, H, W, 3) images and the
    features they are read from, after the last deconvolution's BN and
    ReLU (N, C, h, w)."""
    n = len(s["POSE_RESNET.NUM_DECONV_FILTERS"])
    (x,) = model.backbone(net, images, dict(
        s, **{"DECODER.use_feat_level": [n - 1]}))
    features = F.relu(net.bn(f"backbone.deconv_layers.{3 * n - 2}",
                             x.permute(0, 3, 1, 2)))
    W = net.p.weight(net.w["backbone.final_layer.weight"])
    heatmaps = net.p.act(F.conv2d(net.p.act(features), W,
                                  net.w["backbone.final_layer.bias"]))
    return heatmaps, features


def integrate_2d(heatmaps, multiplier: float):
    """The published `integrate_tensor_2d` with its softmax: (N, K, h, w)
    -> (N, K, 2) x, y in heatmap pixels."""
    N, K, h, w = heatmaps.shape
    x = F.softmax((heatmaps * multiplier).reshape(N, K, -1), dim=2)
    x = x.reshape(N, K, h, w)
    mass_x, mass_y = x.sum(dim=2), x.sum(dim=3)
    xs = (mass_x * torch.arange(w, device=x.device).float()).sum(2)
    ys = (mass_y * torch.arange(h, device=x.device).float()).sum(2)
    return torch.stack([xs, ys], dim=2)


def base_points(hms, rig: dict, s: dict):
    """(B, 3) mm: the base joint of every frame, from one heatmap stack
    (B, J, h, w) per view: the 2D soft-argmax scaled to network pixels,
    back to the full image through the inverse crop affine, undistorted,
    and the column-scaled DLT over the views with equal weights."""
    B, _, h, w = hms[0].shape
    V = len(hms)
    k = s["NETWORK.BASE_JOINT"]
    W, H = s["NETWORK.IMAGE_SIZE"]
    xy = torch.stack([integrate_2d(hm[:, k:k + 1],
                                   s["NETWORK.HEATMAP_MULTIPLIER"])[:, 0]
                      for hm in hms], dim=1)  # (B, V, 2)
    xy = xy * torch.tensor([W / w, H / h], device=xy.device)
    orig = G.apply_affine(xy[:, :, None], rig["inv_affine"])
    und = G.undistort_points(orig, *(rig[c] for c in "fckp"))[:, :, 0]
    proj = G.projection_matrices(rig["R"], rig["T"], rig["f"], rig["c"])
    conf = torch.full((B, V), 1.0 / V, device=xy.device)
    return G.triangulate(proj, und, conf)


def coord_volume(base, side, bins):
    """The published coordinate volume (X, Y, Z, 3) mm of one frame around
    its base point (3,)."""
    device = base.device
    sides = torch.tensor(side, dtype=torch.float32, device=device)
    position = base - sides / 2
    xxx, yyy, zzz = torch.meshgrid(*[torch.arange(n, device=device)
                                     for n in bins], indexing="ij")
    grid = torch.stack([xxx, yyy, zzz], dim=-1).float().reshape(-1, 3)
    coord = torch.zeros_like(grid)
    for a in range(3):
        coord[:, a] = position[a] + (side[a] / (bins[a] - 1)) * grid[:, a]
    # the published eval turns the volume about the base point by 0
    coord = (coord - base) @ torch.eye(3, device=device).T + base
    return coord.reshape(tuple(bins) + (3,))


def unproject(net: model.Net, features, rig: dict, coords, image_size):
    """The published `unproject_heatmaps` with the softmax aggregation:
    features, one (B, C, h, w) per view; coords (B, X, Y, Z, 3) -> the
    volumes (B, C, X, Y, Z), one frame and one view at a time."""
    B, C, h, w = features[0].shape
    V = len(features)
    shape = tuple(coords.shape[1:4])
    out = torch.zeros((B, C) + shape, device=coords.device)
    scale = torch.tensor([w / image_size[0], h / image_size[1]],
                         device=coords.device)
    for i in range(B):
        points = coords[i].reshape(-1, 3)
        per_view = torch.zeros((V, C) + shape, device=coords.device)
        for c in range(V):
            cam = [rig[k][i, c] for k in "RTfckp"]
            depth = (points - cam[1].T) @ cam[0].T
            invalid = depth[:, 2] <= 0.0
            xy = G.project_points(points, *cam)
            xy = G.apply_affine(xy, rig["affine"][i, c]) * scale
            # [-1, 1]: x by the maps' height, y by their width, as published
            grid = torch.stack([2 * (xy[:, 0] / h - 0.5),
                                2 * (xy[:, 1] / w - 0.5)], dim=1)
            got = F.grid_sample(features[c][i:i + 1],
                                grid[None, :, None, :], align_corners=True)
            got = got.reshape(C, -1).clone()
            got[:, invalid] = 0.0
            per_view[c] = net.p.act(got).reshape((C,) + shape)
        weights = F.softmax(per_view.reshape(V, -1), dim=0)
        out[i] = (per_view * weights.reshape(per_view.shape)).sum(0)
    return net.p.act(out)


def v2v_model(net: model.Net, name: str, x):
    """The published V2VModel (N, in, D, H, W) -> (N, out, D, H, W):
    front layers, the five-level encoder-decoder, back layers, output."""
    x = F.relu(bn3d(net, name + ".front_layers.0.block.1",
                    conv3d(net, name + ".front_layers.0.block.0", x)))
    for i in (1, 2, 3):
        x = res3d(net, f"{name}.front_layers.{i}", x)
    e = name + ".encoder_decoder"
    skip_x1 = res3d(net, e + ".skip_res1", x)
    x = res3d(net, e + ".encoder_res1", F.max_pool3d(x, 2, 2))
    skip_x2 = res3d(net, e + ".skip_res2", x)
    x = res3d(net, e + ".encoder_res2", F.max_pool3d(x, 2, 2))
    skip_x3 = res3d(net, e + ".skip_res3", x)
    x = res3d(net, e + ".encoder_res3", F.max_pool3d(x, 2, 2))
    skip_x4 = res3d(net, e + ".skip_res4", x)
    x = res3d(net, e + ".encoder_res4", F.max_pool3d(x, 2, 2))
    skip_x5 = res3d(net, e + ".skip_res5", x)
    x = res3d(net, e + ".encoder_res5", F.max_pool3d(x, 2, 2))
    x = res3d(net, e + ".mid_res", x)
    x = res3d(net, e + ".decoder_res5", x)
    x = up3d(net, e + ".decoder_upsample5", x) + skip_x5
    x = res3d(net, e + ".decoder_res4", x)
    x = up3d(net, e + ".decoder_upsample4", x) + skip_x4
    x = res3d(net, e + ".decoder_res3", x)
    x = up3d(net, e + ".decoder_upsample3", x) + skip_x3
    x = res3d(net, e + ".decoder_res2", x)
    x = up3d(net, e + ".decoder_upsample2", x) + skip_x2
    x = res3d(net, e + ".decoder_res1", x)
    x = up3d(net, e + ".decoder_upsample1", x) + skip_x1
    x = res3d(net, name + ".back_layers.0", x)
    for i in (1, 2):
        x = F.relu(bn3d(net, f"{name}.back_layers.{i}.block.1",
                        conv3d(net, f"{name}.back_layers.{i}.block.0", x)))
    return conv3d(net, name + ".output_layer", x)


def frame(spec: dict, net: model.Net, frame: dict) -> dict:
    """A served frame: the pred (B, 1, J, 5) = xyz | (1.0 > threshold) - 1
    | 1.0, and the base points (B, 3) its cubes sit on."""
    s = model.settings(spec)
    views = frame["views"].float()
    B, V = views.shape[:2]
    rig = model.rig_of(frame)
    side = s["PICT_STRUCT.GRID_SIZE"]
    bins = s["PICT_STRUCT.CUBE_SIZE"]
    with products(net.p.tf32):
        outs = [trunk(net, views[:, c], s) for c in range(V)]
        hms = [hm for hm, _ in outs]
        J = hms[0].shape[1]
        W = net.p.weight(net.w["process_features.0.weight"])
        features = [net.p.act(F.conv2d(net.p.act(f), W,
                                       net.w["process_features.0.bias"]))
                    for _, f in outs]
        base = base_points(hms, rig, s)
        coords = torch.stack([coord_volume(base[i], side, bins)
                              for i in range(B)])
        volumes = unproject(net, features, rig, coords,
                            s["NETWORK.IMAGE_SIZE"])
        volumes = v2v_model(net, "volume_net", volumes)
        prob = F.softmax((volumes * s["NETWORK.BETA"]).reshape(B, J, -1),
                         dim=2).reshape(volumes.shape)
        joints = torch.einsum("bnxyz,bxyzc->bnc", prob, coords)
    score = torch.ones((B, 1, J, 1), device=views.device)
    flag = (score > s["MULTI_PERSON.THRESHOLD"]).float() - 1.0
    return {"pred": torch.cat([joints[:, None], flag, score], dim=-1),
            "base": base}
