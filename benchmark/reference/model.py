"""The plain reference of a served frame: MVGFormer (the DQ decoder with
top-K queries after layer 1, point-top-m and the DLT) and the MvP
baseline, in float32 plain PyTorch.

It follows the published models as the measured port states them
(PoseResNet's pre-BN deconvolution levels, projective attention with the
row-major reading of the stacked level offsets, the per-view offset head,
undistortion and the confidence-weighted DLT; MvP's self-attention, camera
rays and cat_proj view fusion) and shares no code with the port. It works
out again what the port derives: BatchNorm from its running statistics,
the query grid, the projections, the top-K queries and point-top-m. The
Jacobi sweeps of the port's DLT are replaced by a float64 SVD of the same
system, the exact null vector.

`weights` is a dict of float32 tensors keyed by the model's parameter
names; a frame is a dict of float32 tensors: views (B, V, H, W, 3) and the
rig (R, T, f, c, k, p, centers, affine, inv_affine; (B, V, ...)).
`prec` says where to round (`precision.py`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import geometry as G
from benchmark.reference.precision import Float32

LN_EPS = 1e-6
BN_EPS = 1e-5
RESNET_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
STRIDES = (16, 8, 4)  # the deconvolution levels, coarsest first
ATTN_ROWS = 2048  # query rows per block of the plain self-attention


class Net:
    """The weights and the rounding rule, with the layer primitives."""

    def __init__(self, weights: Dict[str, torch.Tensor], prec=Float32):
        self.w, self.p = weights, prec

    def linear(self, name: str, x, compute: bool = True):
        """A linear layer; `compute` marks one that runs in the compute
        dtype (the rest run in float32 on rounded inputs)."""
        W, b = self.w[name + ".weight"], self.w[name + ".bias"]
        if not compute:
            return F.linear(x, W, b)
        return self.p.act(F.linear(self.p.act(x), self.p.weight(W), b))

    def layer_norm(self, name: str, x):
        return self.p.act(F.layer_norm(
            x.float(), x.shape[-1:], self.w[name + ".weight"],
            self.w[name + ".bias"], LN_EPS))

    def mlp(self, name: str, x, layers: int):
        for i in range(layers):
            x = self.linear(f"{name}.{i}", x)
            if i < layers - 1:
                x = F.relu(x)
        return x

    def conv(self, name: str, x, stride: int, pad: int, transpose=False):
        W = self.p.weight(self.w[name + ".weight"])
        op = F.conv_transpose2d if transpose else F.conv2d
        return self.p.act(op(self.p.act(x), W, stride=stride, padding=pad))

    def bn(self, name: str, x):
        w = self.w
        inv = w[name + ".weight"] / torch.sqrt(w[name + ".running_var"]
                                               + BN_EPS)
        shift = w[name + ".bias"] - w[name + ".running_mean"] * inv
        return self.p.act(x * inv[:, None, None] + shift[:, None, None])


def settings(spec: dict) -> dict:
    return spec["settings"]


# --------------------------------------------------------------- backbone


def backbone(net: Net, images: torch.Tensor, s: dict) -> List[torch.Tensor]:
    """PoseResNet on (N, H, W, 3) images: the pre-BN outputs of the
    selected deconvolution levels, NHWC, finest first."""
    x = images.permute(0, 3, 1, 2)
    x = F.relu(net.bn("backbone.bn1", net.conv("backbone.conv1", x, 2, 3)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    inplanes = 64
    for li, (planes, blocks) in enumerate(zip(
            (64, 128, 256, 512), RESNET_BLOCKS[s["POSE_RESNET.NUM_LAYERS"]])):
        for bi in range(blocks):
            stride = (1 if li == 0 else 2) if bi == 0 else 1
            pre = f"backbone.layer{li + 1}.{bi}"
            out = F.relu(net.bn(pre + ".bn1",
                                net.conv(pre + ".conv1", x, 1, 0)))
            out = F.relu(net.bn(pre + ".bn2",
                                net.conv(pre + ".conv2", out, stride, 1)))
            out = net.bn(pre + ".bn3", net.conv(pre + ".conv3", out, 1, 0))
            if bi == 0 and (stride != 1 or inplanes != planes * 4):
                x = net.bn(pre + ".downsample.1",
                           net.conv(pre + ".downsample.0", x, stride, 0))
            x = F.relu(out + x)
            inplanes = planes * 4
    levels = []
    for di in range(len(s["POSE_RESNET.NUM_DECONV_FILTERS"])):
        x = net.conv(f"backbone.deconv_layers.{3 * di}", x, 2, 1,
                     transpose=True)
        levels.append(x)
        x = F.relu(net.bn(f"backbone.deconv_layers.{3 * di + 1}", x))
    keep = [lv.permute(0, 2, 3, 1) for i, lv in enumerate(levels)
            if i in s["DECODER.use_feat_level"]]
    return keep[::-1]


def fold_views(views: torch.Tensor) -> torch.Tensor:
    """(B, V, ...) -> (V*B, ...), view-major."""
    return views.transpose(0, 1).reshape((-1,) + tuple(views.shape[2:]))


# ------------------------------------------------------ sampling, attention


def bilinear(level: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample (N, h, w, C) at (N, S, 2) grid points in [-1, 1]
    (align_corners=False, zero padding) -> (N, S, C)."""
    out = F.grid_sample(level.permute(0, 3, 1, 2).float(), grid[:, :, None],
                        mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out[..., 0].transpose(1, 2)


def deform_sample(value, shapes, loc, weights):
    """sum over levels and points of weight x bilinear(value) at loc * size
    - 0.5: value (N, Len, H, D), loc (N, Lq, H, L, P, 2), weights
    (N, Lq, H, L, P) -> (N, Lq, H * D)."""
    N, _, H, D = value.shape
    Lq, P = loc.shape[1], loc.shape[4]
    out, start = 0.0, 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w].reshape(N, h, w, H, D)
        v = v.permute(0, 3, 4, 1, 2).reshape(N * H, D, h, w).float()
        g = loc[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(
            N * H, Lq, P, 2) * 2.0 - 1.0
        got = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                            align_corners=False)  # (N*H, D, Lq, P)
        wt = weights[:, :, :, lvl].permute(0, 2, 1, 3).reshape(
            N * H, 1, Lq, P).float()
        out = out + (got * wt).sum(-1)
        start += h * w
    return out.reshape(N, H, D, Lq).permute(0, 3, 1, 2).reshape(N, Lq, H * D)


def top_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest along the last axis, the lower index first in a
    tie."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


def proj_attn(net: Net, name: str, query, ref, levels, shapes, s: dict,
              point_topm: Optional[int] = None, rays=None):
    """Projective attention: query (N, Lq, C), ref (N, Lq, L, 2) per-level
    normalized centres, levels (N, h, w, C) finest first."""
    N, Lq, C = query.shape
    H, P = s["DECODER.nhead"], s["DECODER.dec_n_points"]
    ref_feats = torch.stack(
        [bilinear(lv, torch.clamp(ref[:, :, i] * 2.0 - 1.0, -1.1, 1.1))
         for i, lv in enumerate(levels)], dim=2)  # (N, Lq, L, C)
    flat = torch.cat([lv.reshape(N, -1, C) for lv in levels], dim=1)
    if rays is not None:
        flat = torch.cat([flat, net.p.act(rays)], dim=-1)
    value = net.linear(name + ".rayconv", flat).reshape(N, -1, H, C // H)
    mix = net.p.act(ref_feats + query[:, :, None, :])
    offsets = net.linear(name + ".sampling_offsets", mix, compute=False)
    logits = net.linear(name + ".attention_weights", mix, compute=False)
    Lt = len(levels) * s["DECODER.num_feature_levels"]
    offsets = offsets.reshape(N, Lq, H, Lt, P, 2)
    weights = torch.softmax(logits.reshape(N, Lq, H, Lt * P), dim=-1)
    weights = weights.reshape(N, Lq, H, Lt, P)
    size = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                        device=query.device)
    loc = ref[:, :, None, :, None, :] + offsets / size[:, None, :]
    if point_topm is not None and point_topm < P:
        idx = top_indices(weights, point_topm)
        kept = torch.gather(weights, -1, idx)
        weights = kept / torch.clamp(kept.sum(dim=(-2, -1), keepdim=True),
                                     min=1e-6)
        loc = torch.gather(loc, 4, idx[..., None].expand(idx.shape + (2,)))
    out = deform_sample(value, shapes, loc, net.p.act(weights))
    return net.linear(name + ".output_proj", net.p.act(out))


def self_attention(net: Net, name: str, q, v, heads: int):
    """softmax(q k^T / sqrt(d)) v over (B, L, C), q = k, in blocks of
    query rows."""
    B, L, C = q.shape
    d = C // heads
    W, b = net.w[name + ".in_proj_weight"], net.w[name + ".in_proj_bias"]

    def proj(x, i):
        y = F.linear(net.p.act(x), net.p.weight(W[i * C:(i + 1) * C]),
                     b[i * C:(i + 1) * C])
        return net.p.act(y).reshape(B, L, heads, d).transpose(1, 2)

    qh, kh, vh = proj(q, 0), proj(q, 1), proj(v, 2)
    out = torch.empty_like(qh)
    for r in range(0, L, ATTN_ROWS):
        scores = (qh[:, :, r:r + ATTN_ROWS] / math.sqrt(d)) @ kh.transpose(
            -1, -2)
        out[:, :, r:r + ATTN_ROWS] = torch.softmax(scores, dim=-1) @ vh
    return net.linear(name + ".out_proj",
                      net.p.act(out.transpose(1, 2).reshape(B, L, C)))


# ---------------------------------------------------------------- the grid


def level_shapes(s: dict):
    W, H = s["NETWORK.IMAGE_SIZE"]
    keep = [st for i, st in enumerate(STRIDES)
            if i in s["DECODER.use_feat_level"]][::-1]
    return tuple((H // st, W // st) for st in keep)


def query_grid(spec: dict) -> torch.Tensor:
    """(Q * J, 3) mm: a ceil(sqrt(Q))^2 grid over the capture space's
    (x, y) at mid height, plus the T-pose offsets of each joint."""
    s = settings(spec)
    Q = s["DECODER.num_instance"]
    n = math.ceil(Q ** 0.5)
    lin = np.linspace(0.0, 1.0, n, dtype=np.float32)
    gx, gy = np.meshgrid(lin, lin, indexing="ij")
    roots = np.stack([gx.reshape(-1), gy.reshape(-1),
                      np.full(n * n, 0.5, np.float32)], -1)[:Q]
    size = np.asarray(s["MULTI_PERSON.SPACE_SIZE"], np.float32)
    centre = np.asarray(s["MULTI_PERSON.SPACE_CENTER"], np.float32)
    roots = roots * size + centre - size / 2.0
    joints = roots[:, None] + np.asarray(spec["t_pose"], np.float32)[None]
    return torch.from_numpy(joints.reshape(-1, 3).astype(np.float32))


def project_refs(refs, rig, shapes, img_wh, clamp_hi):
    """3D refs (B, Nq, 3) -> (normalized net-image points (B, V, Nq, 2),
    per-level points (B, V, Nq, L, 2), in-image mask (B, V, Nq))."""
    B, Nq, _ = refs.shape
    V = rig["R"].shape[1]
    pix = G.project_points(refs[:, None].expand(B, V, Nq, 3),
                           *(rig[k] for k in "RTfckp"))
    wh = rig["centers"] * 2.0
    inside = ((pix[..., 0] >= 0) & (pix[..., 1] >= 0)
              & (pix[..., 0] < wh[..., 0:1]) & (pix[..., 1] < wh[..., 1:2]))
    pix = torch.minimum(torch.clamp(pix, min=-1.0), clamp_hi)
    norm = G.apply_affine(pix, rig["affine"]) / img_wh
    size = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                        device=refs.device)
    return norm, norm[..., None, :] * (size / (size - 1.0)), inside


def take(x, sel, J: int, axis: int):
    """The selected queries' rows of an axis of Q * J entries; sel
    (B, K)."""
    x = x.movedim(axis, 1)
    B = x.shape[0]
    x = x.reshape((B, -1, J) + x.shape[2:])
    got = x[torch.arange(B, device=x.device)[:, None], sel]
    return got.reshape((B, -1) + got.shape[3:]).movedim(1, axis)


def scatter(x, sel, Q: int, J: int, axis: int):
    """Inverse of `take`: the rows placed into zeros of Q * J."""
    x = x.movedim(axis, 1)
    B, K = sel.shape
    x = x.reshape((B, K, J) + x.shape[2:])
    dense = x.new_zeros((B, Q) + x.shape[2:])
    dense[torch.arange(B, device=x.device)[:, None], sel] = x
    return dense.reshape((B, Q * J) + x.shape[3:]).movedim(1, axis)


def inverse_sigmoid(x, eps: float = 1e-5):
    x = torch.clamp(x, 0.0, 1.0)
    return torch.log(torch.clamp(x, min=eps) / torch.clamp(1.0 - x, min=eps))


def pred_array(poses, class_prob, threshold: float):
    """(B, Q, J, 5) = xyz | (score > threshold) - 1 | score, the score the
    sigmoid of the logit of the mean joint probability."""
    B, Q = class_prob.shape[:2]
    poses = poses.reshape(B, Q, -1, 3)
    J = poses.shape[2]
    score = torch.sigmoid(inverse_sigmoid(class_prob)[..., 1:2])
    score = score[:, :, None].expand(B, Q, J, 1)
    return torch.cat([poses, (score > threshold).float() - 1.0, score], -1)


def rig_of(frame: dict) -> dict:
    return {k: frame[k].float() for k in
            ("R", "T", "f", "c", "k", "p", "centers", "affine", "inv_affine")}


# ------------------------------------------------------------- MVGFormer


def dq_attend(net: Net, name: str, tgt, qpos, refs, levels, shapes, rig,
              clamp_hi, s: dict, threshold: float, train: bool = False,
              drop=lambda x: x):
    """Stages 1-5 of a decoder layer: project, attend, fuse the view mean,
    the FFN (dropout by `drop` after the view-mean update, the ReLU and the
    second linear layer), classify. In training no point-top-m. Returns
    (features (B, Nq, C), class probabilities (B, Q, 2), per-view features
    (V, B, Nq, C), normalized projections (B, V, Nq, 2), active mask
    (B, Nq))."""
    B, Nq, C = tgt.shape
    V = rig["R"].shape[1]
    J = s["DECODER.num_keypoints"]
    img = image_wh(s, tgt.device)
    norm, lvl, inside = project_refs(refs, rig, shapes, img, clamp_hi)
    q = (tgt + qpos)[None].expand(V, B, Nq, C).reshape(V * B, Nq, C)
    attn = proj_attn(net, name + ".proj_attn", q,
                     lvl.transpose(0, 1).reshape(V * B, Nq, len(shapes), 2),
                     levels, shapes, s, point_topm=None if train
                     else s["DECODER.inference_point_topm"])
    attn = attn.reshape(V, B, Nq, C) * inside.transpose(0, 1)[..., None]
    mean = net.p.act(attn.mean(dim=0))
    x = net.layer_norm(name + ".norm2", tgt + drop(
        net.linear(name + ".feature_update_mlp", mean)))
    ffn = net.linear(name + ".linear2",
                     drop(F.relu(net.linear(name + ".linear1", x))))
    x = net.layer_norm(name + ".norm3", x + drop(ffn))
    prob = torch.sigmoid(net.linear(name + ".class_embed", x))
    class_prob = prob.reshape(B, Nq // J, J, 2).mean(dim=2)
    keep = (class_prob[..., 1] > threshold).repeat_interleave(J, dim=1)
    return x, class_prob, attn, norm, keep


def dq_triangulate(net: Net, name: str, attn, norm, keep, rig, pm,
                   s: dict):
    """Stages 7-9 on the queries given: the per-view offsets and
    confidences, the inverse crop and undistortion, the weighted DLT.
    Returns the new refs (B, Nq, 3) and the refined 2D points (B, V, Nq,
    2), zero where a query is inactive."""
    V, B, Nq, _ = attn.shape
    img = image_wh(s, attn.device)
    head = net.mlp(name + ".pose_embed.MLP.layers", attn,
                   s["DECODER.pose_embed_layer"])
    refined = (norm.transpose(0, 1) + head[..., :2].float() / img) * img
    points = torch.where(keep[None, :, :, None], refined, img * 0.5)
    orig = G.apply_affine(points.transpose(0, 1), rig["inv_affine"])
    und = G.undistort_points(orig, *(rig[k] for k in "fckp"))
    conf = torch.softmax(head[..., 2].float(), dim=0)  # over the views
    new = G.triangulate(pm[:, None].expand(B, Nq, V, 3, 4),
                        und.transpose(1, 2), conf.permute(1, 2, 0))
    return (torch.where(keep[..., None], new, 0.0),
            torch.where(keep[:, None, :, None], refined.transpose(0, 1), 0.0))


def image_wh(s: dict, device) -> torch.Tensor:
    return torch.tensor(s["NETWORK.IMAGE_SIZE"], dtype=torch.float32,
                        device=device)


def dq_frame(spec: dict, net: Net, frame: dict,
             select: Optional[torch.Tensor] = None,
             history: Optional[list] = None) -> dict:
    """A served MVGFormer frame. The top-K queries of layer 1 (whose offset
    head and triangulation run on them, as every later layer does) are
    `select` (B, K) where given (the queries a judged pred chose), else
    the reference's own. Returns the pred (B, Q, J, 5), layer 1's class
    probabilities (B, Q) and the queries used (B, K); `history`, where
    given, receives each layer's class probabilities and new refs."""
    s = settings(spec)
    views = frame["views"].float()
    B = views.shape[0]
    rig = rig_of(frame)
    levels = backbone(net, fold_views(views), s)
    shapes = level_shapes(s)
    Q, J = s["DECODER.num_instance"], s["DECODER.num_keypoints"]
    C = s["DECODER.d_model"]
    emb = (net.w["joint_embedding.weight"][None]
           + net.w["instance_embedding.weight"][:, None]).reshape(Q * J, -1)
    qpos = net.p.act(emb[None, :, :C].expand(B, -1, -1))
    tgt = net.p.act(emb[None, :, C:].expand(B, -1, -1))
    refs = query_grid(spec).to(views.device)[None].expand(B, -1, -1)
    clamp_hi = (rig["centers"] * 2.0).amax(dim=(0, 2))[:, None, None]
    pm = G.projection_matrices(rig["R"], rig["T"], rig["f"], rig["c"])
    threshold = s["MULTI_PERSON.THRESHOLD"]
    sel = first = None
    for lid in range(s["DECODER.num_decoder_layers"]):
        name = f"decoder.layers.{lid}"
        x, cp, attn, norm, keep = dq_attend(net, name, tgt, qpos, refs,
                                            levels, shapes, rig, clamp_hi, s,
                                            threshold)
        if lid == 0:
            first = cp[..., 1]
            sel = (select if select is not None else
                   top_indices(first, s["DECODER.inference_topk_queries"]))
            attn, norm = take(attn, sel, J, 2), take(norm, sel, J, 2)
            keep, x = take(keep, sel, J, 1), take(x, sel, J, 1)
            qpos = take(qpos, sel, J, 1)
        tgt, refs = x, dq_triangulate(net, name, attn, norm, keep, rig, pm,
                                      s)[0]
        if history is not None:
            history.append({"class_prob": cp, "refs": refs})
    poses = scatter(refs, sel, Q, J, 1)
    class_prob = scatter(cp, sel, Q, 1, 1)
    return {"pred": pred_array(poses, class_prob, threshold),
            "layer1_scores": first, "select": sel}


# ------------------------------------------------------------------- MvP


def camera_rays(rig: dict, shapes, img_wh) -> torch.Tensor:
    """Unit world-space ray directions of every pixel of every level,
    view-major (V*B, sum hw, 3): the crop-composed intrinsics scaled to
    the level, pixel -> camera -> world."""
    B, V = rig["R"].shape[:2]
    K = G.intrinsics(rig["f"], rig["c"])
    bottom = torch.tensor([0.0, 0.0, 1.0], device=K.device).expand(
        B, V, 1, 3)
    K = torch.cat([rig["affine"], bottom], dim=-2) @ K
    R = rig["R"]
    t = -(R @ rig["T"])  # x_cam = R x + t
    out = []
    for h, w in shapes:
        Kl = K.clone()
        Kl[..., :2, :] *= w / float(img_wh[0])
        jj, ii = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                             device=K.device),
                                torch.arange(w, dtype=torch.float32,
                                             device=K.device), indexing="ij")
        pix = torch.stack([ii, jj, torch.ones_like(ii)], -1).reshape(-1, 3)
        cam = pix @ torch.linalg.inv(Kl).transpose(-1, -2)  # (B, V, hw, 3)
        world = (cam - t.transpose(-1, -2)) @ R
        d = world - (-(R.transpose(-1, -2) @ t)).transpose(-1, -2)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        out.append(d.transpose(0, 1).reshape(V * B, h * w, 3))
    return torch.cat(out, dim=1)


def mvp_frame(spec: dict, net: Net, frame: dict) -> dict:
    """A served MvP frame: per layer self-attention over the queries,
    projective attention over every view with camera rays, cat_proj view
    fusion, the FFN, then the refs refined in inverse-sigmoid space.
    Returns the pred (B, Q, J, 5)."""
    s = settings(spec)
    views = frame["views"].float()
    B, V = views.shape[:2]
    rig = rig_of(frame)
    levels = backbone(net, fold_views(views), s)
    shapes = level_shapes(s)
    Q, J = s["DECODER.num_instance"], s["DECODER.num_keypoints"]
    C = s["DECODER.d_model"]
    Nq = Q * J
    size, centre = (s["MULTI_PERSON.SPACE_SIZE"],
                    s["MULTI_PERSON.SPACE_CENTER"])
    img = image_wh(s, views.device)
    emb = (net.w["joint_embedding.weight"][None]
           + net.w["instance_embedding.weight"][:, None]).reshape(Nq, -1)
    qpos32 = emb[None, :, :C].expand(B, -1, -1)
    base = qpos32
    if s["DECODER.query_adaptation"]:
        pooled = torch.cat([lv.float().mean(dim=(1, 2)) for lv in levels], -1)
        pooled = pooled.reshape(V, B, -1).transpose(0, 1).reshape(B, -1)
        base = base + net.linear("reference_feats", pooled,
                                 compute=False)[:, None]
    ref = torch.sigmoid(net.linear("reference_points", base, compute=False))
    qpos = net.p.act(qpos32)
    tgt = net.p.act(emb[None, :, C:].expand(B, -1, -1))
    rays = (camera_rays(rig, shapes, s["NETWORK.IMAGE_SIZE"])
            if s["DECODER.projattn_posembed_mode"] == "use_rayconv" else None)
    whl = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                       device=views.device)
    for lid in range(s["DECODER.num_decoder_layers"]):
        name = f"decoder.layers.{lid}"
        q = tgt + qpos
        tgt = net.layer_norm(name + ".norm2", tgt + self_attention(
            net, name + ".self_attn", q, tgt, s["DECODER.nhead"]))
        mm = G.norm_to_mm(ref.float(), size, centre)
        pix = G.project_points(mm[:, None].expand(B, V, Nq, 3),
                               *(rig[k] for k in "RTfckp"))
        wh = rig["centers"] * 2.0
        inside = ((pix[..., 0] >= 0) & (pix[..., 1] >= 0)
                  & (pix[..., 0] < wh[..., 0:1])
                  & (pix[..., 1] < wh[..., 1:2]))
        pix = torch.minimum(torch.clamp(pix, min=-1.0), wh.max())
        norm = G.apply_affine(pix, rig["affine"]) / img
        lvl = norm[..., None, :] * (whl / (whl - 1.0))
        qf = (tgt + qpos)[None].expand(V, B, Nq, C).reshape(V * B, Nq, C)
        attn = proj_attn(net, name + ".proj_attn", qf,
                         lvl.transpose(0, 1).reshape(V * B, Nq, len(shapes),
                                                     2),
                         levels, shapes, s, rays=rays)
        attn = attn.reshape(V, B, Nq, C) * inside.transpose(0, 1)[..., None]
        fused = net.linear(name + ".fuse_view_projection",
                           attn.permute(1, 2, 0, 3).reshape(B, Nq, V * C))
        tgt = net.layer_norm(name + ".norm1", tgt + fused)
        ffn = net.linear(name + ".linear2",
                         F.relu(net.linear(name + ".linear1", tgt)))
        tgt = net.layer_norm(name + ".norm3", tgt + ffn)
        delta = net.mlp(f"pose_embed.{lid}.layers", tgt,
                        s["DECODER.pose_embed_layer"]).float()
        ref = torch.sigmoid(delta + inverse_sigmoid(ref))
        prob = torch.sigmoid(net.linear(f"class_embed.{lid}", tgt))
        class_prob = prob.reshape(B, Q, J, 2).mean(dim=2)
    poses = G.norm_to_mm(ref, size, centre)
    return {"pred": pred_array(poses, class_prob,
                               s["MULTI_PERSON.THRESHOLD"])}

