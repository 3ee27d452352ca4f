"""The reference frame of VoxelPose (TRANSFORMER voxelpose), in float32
plain PyTorch.

It states the forward of microsoft/voxelpose-pytorch (`lib/models/`
`multi_person_posenet.py`, `cuboid_proposal_net.py`,
`pose_regression_net.py`, `project_layer.py`, `v2v_net.py`) as published
and shares no code with the port: PoseResNet through `model.backbone` on
one view at a time, then the heatmap head (the last deconvolution's BN and
ReLU, the 1x1 `final_layer`); the volumes built as `ProjectLayer.
get_voxel` builds them, one batch item and one view at a time, each view's
samples added into its slot and averaged over the views whose image holds
the voxel; V2VNet from the weights by name; the 3x3x3 max-pool NMS and
the top-K; and the published loop over the candidates, which runs the PRN
on a candidate only where some batch item holds it valid (the host asks)
and leaves the rows of the others zero.

The weights are the port's state dict by name (`root_net.` and
`pose_net.` for the published `root_net.v2v_net.` and `pose_net.v2v_net.`);
`net.p` says where to round (`precision.py`). The frame runs under
`products(net.p.tf32)`: both TF32 flags off for the float32 reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import geometry as G
from benchmark.reference import model
from benchmark.reference.precision import products


def conv3d(net: model.Net, name: str, x, transpose: bool = False):
    """A 3D convolution with its bias: 'same' padding, or a stride-2
    transposed convolution of kernel 2."""
    W = net.p.weight(net.w[name + ".weight"])
    b = net.w[name + ".bias"]
    if transpose:
        y = F.conv_transpose3d(net.p.act(x), W, b, stride=2)
    else:
        y = F.conv3d(net.p.act(x), W, b, padding=W.shape[-1] // 2)
    return net.p.act(y)


def bn3d(net: model.Net, name: str, x):
    w = net.w
    inv = w[name + ".weight"] / torch.sqrt(w[name + ".running_var"]
                                           + model.BN_EPS)
    shift = w[name + ".bias"] - w[name + ".running_mean"] * inv
    return net.p.act(x * inv[:, None, None, None]
                     + shift[:, None, None, None])


def res3d(net: model.Net, name: str, x):
    """Res3DBlock: two 3^3 convolutions with BN, plus the input (through a
    1^3 convolution and BN where the block has one), then ReLU."""
    y = F.relu(bn3d(net, name + ".res_branch.1",
                    conv3d(net, name + ".res_branch.0", x)))
    y = bn3d(net, name + ".res_branch.4", conv3d(net, name + ".res_branch.3",
                                                  y))
    if name + ".skip_con.0.weight" in net.w:
        x = bn3d(net, name + ".skip_con.1", conv3d(net, name + ".skip_con.0",
                                                   x))
    return F.relu(y + x)


def up3d(net: model.Net, name: str, x):
    return F.relu(bn3d(net, name + ".block.1",
                       conv3d(net, name + ".block.0", x, transpose=True)))


def v2v(net: model.Net, name: str, x):
    """V2VNet (N, in, D, H, W) -> (N, out, D, H, W)."""
    x = F.relu(bn3d(net, name + ".front_layers.0.block.1",
                    conv3d(net, name + ".front_layers.0.block.0", x)))
    x = res3d(net, name + ".front_layers.1", x)
    e = name + ".encoder_decoder"
    skip_x1 = res3d(net, e + ".skip_res1", x)
    x = res3d(net, e + ".encoder_res1", F.max_pool3d(x, 2, 2))
    skip_x2 = res3d(net, e + ".skip_res2", x)
    x = res3d(net, e + ".encoder_res2", F.max_pool3d(x, 2, 2))
    x = res3d(net, e + ".mid_res", x)
    x = res3d(net, e + ".decoder_res2", x)
    x = up3d(net, e + ".decoder_upsample2", x) + skip_x2
    x = res3d(net, e + ".decoder_res1", x)
    x = up3d(net, e + ".decoder_upsample1", x) + skip_x1
    return conv3d(net, name + ".output_layer", x)


def heatmaps(net: model.Net, images, s: dict):
    """PoseResNet's heatmaps (N, J, h, w) of (N, H, W, 3) images."""
    n = len(s["POSE_RESNET.NUM_DECONV_FILTERS"])
    (x,) = model.backbone(net, images, dict(
        s, **{"DECODER.use_feat_level": [n - 1]}))
    x = F.relu(net.bn(f"backbone.deconv_layers.{3 * n - 2}",
                      x.permute(0, 3, 1, 2)))
    W = net.p.weight(net.w["backbone.final_layer.weight"])
    return net.p.act(F.conv2d(net.p.act(x), W,
                              net.w["backbone.final_layer.bias"]))


def compute_grid(box_size, box_center, bins, device):
    """(prod(bins), 3) mm: linspace over each axis plus the centre, x
    slowest (the published `compute_grid`)."""
    axes = [torch.linspace(-box_size[i] / 2, box_size[i] / 2, bins[i],
                           device=device) + box_center[i] for i in range(3)]
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], 1)


def get_voxel(hms, rig: dict, image_size, grid_size, centers, bins):
    """The published `ProjectLayer.get_voxel`: hms, one (B, J, h, w) per
    view; centers, one (3,) per batch item, or None where the item's
    candidate is invalid (its cube stays zero). Returns the cubes
    (B, J, *bins) and the grids (B, prod(bins), 3)."""
    device = hms[0].device
    B, J, h, w = hms[0].shape
    V = len(hms)
    nbins = bins[0] * bins[1] * bins[2]
    cubes = torch.zeros(B, J, 1, nbins, V, device=device)
    bounding = torch.zeros(B, 1, 1, nbins, V, device=device)
    grids = torch.zeros(B, nbins, 3, device=device)
    hm_wh = torch.tensor([w, h], dtype=torch.float32, device=device)
    img = torch.tensor(image_size, dtype=torch.float32, device=device)
    for i in range(B):
        if centers[i] is None:
            continue
        grid = compute_grid(grid_size, centers[i], bins, device)
        grids[i] = grid
        for c in range(V):
            width, height = (rig["centers"][i, c] * 2.0).tolist()
            xy = G.project_points(grid, *(rig[k][i, c] for k in "RTfckp"))
            bounding[i, 0, 0, :, c] = ((xy[:, 0] >= 0) & (xy[:, 1] >= 0)
                                       & (xy[:, 0] < width)
                                       & (xy[:, 1] < height)).float()
            xy = torch.clamp(xy, -1.0, max(width, height))
            xy = G.apply_affine(xy, rig["affine"][i, c])
            xy = xy * hm_wh / img
            sample_grid = xy / (hm_wh - 1.0) * 2.0 - 1.0
            sample_grid = torch.clamp(sample_grid.view(1, 1, nbins, 2),
                                      -1.1, 1.1)
            cubes[i:i + 1, :, :, :, c] += F.grid_sample(
                hms[c][i:i + 1], sample_grid, align_corners=True)
    cubes = (torch.sum(cubes * bounding, dim=-1)
             / (torch.sum(bounding, dim=-1) + 1e-6))
    cubes[cubes != cubes] = 0.0
    cubes = cubes.clamp(0.0, 1.0)
    return cubes.view((B, J) + tuple(bins)), grids


def nms(root_cubes, max_num: int):
    """The top `max_num` voxels after a 3x3x3 max-pool NMS: values (B, K),
    indices (B, K, 3) along the cube's axes."""
    peak = F.max_pool3d(root_cubes, kernel_size=3, stride=1, padding=1)
    kept = (root_cubes == peak).float() * root_cubes
    B = root_cubes.shape[0]
    values, index = kept.reshape(B, -1).topk(max_num)
    _, Y, Z = root_cubes.shape[1:]
    ijk = torch.stack([index // (Y * Z), (index % (Y * Z)) // Z, index % Z],
                      dim=2)
    return values, ijk


def frame(spec: dict, net: model.Net, frame: dict) -> dict:
    """A served VoxelPose frame: the pred (B, M, J, 5) = xyz | (score >
    threshold) - 1 | score, rows in descending root score, xyz 0 where no
    batch item's candidate of that row is valid."""
    s = model.settings(spec)
    views = frame["views"].float()
    B, V = views.shape[:2]
    rig = model.rig_of(frame)
    device = views.device
    M = s["MULTI_PERSON.MAX_PEOPLE_NUM"]
    size = s["MULTI_PERSON.SPACE_SIZE"]
    centre = s["MULTI_PERSON.SPACE_CENTER"]
    root_bins = s["MULTI_PERSON.INITIAL_CUBE_SIZE"]
    with products(net.p.tf32):
        hms = [heatmaps(net, views[:, c], s) for c in range(V)]
        J = hms[0].shape[1]
        # the cuboid proposal network
        cubes, _ = get_voxel(hms, rig, s["NETWORK.IMAGE_SIZE"], size,
                             [centre] * B, root_bins)
        root_cubes = v2v(net, "root_net", cubes)[:, 0]
        values, ijk = nms(root_cubes, M)
        bins = torch.tensor(root_bins, dtype=torch.float32, device=device)
        size_t = torch.tensor(size, dtype=torch.float32, device=device)
        loc = (ijk.float() / (bins - 1) * size_t
               + torch.tensor(centre, dtype=torch.float32, device=device)
               - size_t / 2.0)
        grid_centers = torch.zeros(B, M, 5, device=device)
        grid_centers[:, :, 0:3] = loc
        grid_centers[:, :, 4] = values
        grid_centers[:, :, 3] = ((values > s["MULTI_PERSON.THRESHOLD"])
                                 .float() - 1.0)
        # the pose regression network, candidate by candidate
        pred = torch.zeros(B, M, J, 5, device=device)
        pred[:, :, :, 3:] = grid_centers[:, :, 3:].reshape(B, -1, 1, 2)
        for n in range(M):
            index = pred[:, n, 0, 3] >= 0
            if torch.sum(index) > 0:
                pred[:, n, :, 0:3] = prn(net, s, hms, rig,
                                         grid_centers[:, n])
    return {"pred": pred}


def prn(net: model.Net, s: dict, hms, rig: dict, grid_centers):
    """The published `PoseRegressionNet` on one candidate of each batch
    item, grid_centers (B, 5): the joints (B, J, 3), zero where the
    candidate is invalid."""
    B, J = hms[0].shape[:2]
    centers = [grid_centers[i, :3] if grid_centers[i, 3] >= 0 else None
               for i in range(B)]
    cubes, grids = get_voxel(hms, rig, s["NETWORK.IMAGE_SIZE"],
                             s["PICT_STRUCT.GRID_SIZE"], centers,
                             s["PICT_STRUCT.CUBE_SIZE"])
    pred = torch.zeros(B, J, 3, device=cubes.device)
    index = grid_centers[:, 3] >= 0
    valid = v2v(net, "pose_net", cubes[index])
    pred[index] = soft_argmax(valid, grids[index], s["NETWORK.BETA"])
    return pred


def soft_argmax(x, grids, beta: float):
    """The expected grid point under softmax(beta x) over each channel's
    volume: x (N, J, D, H, W), grids (N, D*H*W, 3) -> (N, J, 3)."""
    N, J = x.shape[:2]
    x = F.softmax(beta * x.reshape(N, J, -1, 1), dim=2)
    return torch.sum(x * grids.unsqueeze(1), dim=2)
