"""The plain reference of MVGFormer's training step: the gt match on the
query grid, the training forward (dropout, no top-K or point-top-m), the
set criterion, the backward and the clipped two-group Adam, in float32
plain PyTorch with autograd.

Dropout draws its masks as the published training does them in the
measured system: one seed per layer and step from a CPU generator seeded
by the run, each layer's masks from a card generator seeded by it, drawn
after the view-mean update, after the FFN's ReLU and after its second
linear layer. The same seeds give the same masks, so the reference takes
the seed, not the masks.

The criterion (the configuration's: focal classification, per-joint L1
and per-view 2D reprojection L1 over the KNN gt match of the initial
queries, every layer weighted 1):

    loss_ce       = sum focal(logits, matched) / n
    loss_perjoint = sum |pose - gt| vis / (n J 3)
    loss_2d       = sum |pose_2d - affine(project(gt))| vis_2d / (n V J 2)
    total         = sum over layers of 2 loss_ce + 5 loss_perjoint
                    + 5 loss_2d,   n = max(people in the batch, 1).

The optimizer clips the global norm of every trainable gradient to
TRAIN.clip_max_norm, then Adam (b1 0.9, b2 0.999, eps 1e-8 outside the
root, bias corrected) at TRAIN.LR, times DECODER.lr_linear_proj_mult for
the names holding `sampling_offsets` or `reference_points`; the backbone
is frozen.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference import geometry as G
from benchmark.reference import model as M

B1, B2, EPS = 0.9, 0.999, 1e-8
LOSS_WEIGHTS = (("loss_ce", "DECODER.loss_weight_loss_ce"),
                ("loss_pose_perjoint", "DECODER.loss_pose_perjoint"),
                ("loss_pose_perprojection_2d",
                 "DECODER.loss_pose_perprojection_2d"))


def layer_seeds(generator: torch.Generator, layers: int) -> List[int]:
    """One dropout seed per layer for a step, from the CPU generator."""
    return torch.randint(0, 2 ** 62, (layers,), generator=generator).tolist()


def dropout(p: float, seed: int, device):
    """The dropout of one layer: keep with probability 1 - p, the kept
    values scaled by 1 / (1 - p), the masks from a card generator seeded
    by `seed`."""
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def drop(x):
        keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))

    return drop


def knn_match(grid: torch.Tensor, gt: torch.Tensor, people: torch.Tensor,
              k: int):
    """The k queries of the grid (Q, J, 3) nearest each gt person (B, M,
    J, 3) by the L1 distance of their poses: (query index (B, M, k), valid
    person (B, M), matched query (B, Q))."""
    cost = (grid[None, :, None] - gt[:, None]).abs().sum(dim=(-1, -2))
    idx = M.top_indices(-cost.transpose(1, 2), k)
    valid = torch.arange(gt.shape[1], device=gt.device)[None] < people[:, None]
    matched = torch.zeros(cost.shape[:2], dtype=torch.bool, device=gt.device)
    for b in range(gt.shape[0]):
        matched[b, idx[b][valid[b]].reshape(-1)] = True
    return idx, valid, matched


def focal(logits, targets, alpha: float = 0.25, gamma: float = 2.0):
    prob = torch.sigmoid(logits)
    ce = F.binary_cross_entropy_with_logits(logits, targets,
                                            reduction="none")
    p_t = prob * targets + (1 - prob) * (1 - targets)
    return (alpha * targets + (1 - alpha) * (1 - targets)) * ce * (
        1 - p_t) ** gamma


def pairs(x, idx):
    """x (B, Q, ...) at the matched pairs idx (B, M, K)."""
    B, Mp, K = idx.shape
    out = x[torch.arange(B, device=x.device)[:, None], idx.reshape(B, -1)]
    return out.reshape((B, Mp, K) + tuple(x.shape[2:]))


def layer_losses(s: dict, logits, poses, poses_2d, frame: dict,
                 targets: dict, match) -> Dict[str, torch.Tensor]:
    idx, valid, matched = match
    gt, vis = targets["joints_3d"], targets["joints_3d_vis"]
    B, Mp, J, _ = gt.shape
    V = frame["R"].shape[1]
    n = torch.clamp(targets["num_person"].sum().float(), min=1.0)
    w = valid.float()[:, :, None]
    onehot = torch.stack([torch.zeros_like(matched), matched], -1).float()
    out = {"loss_ce": focal(logits, onehot).sum() / n}
    src = pairs(poses.reshape(B, -1, J, 3), idx)
    out["loss_pose_perjoint"] = ((src - gt[:, :, None]).abs()
                                 * vis[:, :, None, :, None]
                                 * w[..., None, None]).sum() / (n * J * 3)
    src2d = pairs(poses_2d.reshape(B, V, -1, J, 2).transpose(1, 2), idx)
    proj = G.project_points(gt.reshape(B, 1, -1, 3).expand(B, V, -1, 3),
                            *(frame[k] for k in "RTfckp"))
    proj = G.apply_affine(proj, frame["affine"]).reshape(B, V, Mp, J, 2)
    vis2d = targets["joints_vis_2d"].transpose(1, 2)  # (B, M, V, J)
    loss2d = ((src2d - proj.transpose(1, 2)[:, :, None]).abs()
              * vis2d[:, :, None, :, :, None]
              * w[..., None, None, None]).sum() / (n * V * J * 2)
    out["loss_pose_perprojection_2d"] = torch.where(
        loss2d > 1e5, torch.zeros_like(loss2d), loss2d)
    return out


def losses(spec: dict, net: M.Net, frame: dict, targets: dict,
           seeds: List[int]) -> Dict[str, torch.Tensor]:
    """The training forward and the criterion of one batch."""
    s = M.settings(spec)
    views = frame["views"].float()
    B = views.shape[0]
    rig = M.rig_of(frame)
    with torch.no_grad():  # the backbone is frozen
        levels = M.backbone(net, M.fold_views(views), s)
    shapes = M.level_shapes(s)
    Q, J = s["DECODER.num_instance"], s["DECODER.num_keypoints"]
    C = s["DECODER.d_model"]
    emb = (net.w["joint_embedding.weight"][None]
           + net.w["instance_embedding.weight"][:, None]).reshape(Q * J, -1)
    qpos = net.p.act(emb[None, :, :C].expand(B, -1, -1))
    tgt = net.p.act(emb[None, :, C:].expand(B, -1, -1))
    grid = M.query_grid(spec).to(views.device)
    refs = grid[None].expand(B, -1, -1)
    match = knn_match(grid.reshape(Q, J, 3), targets["joints_3d"],
                      targets["num_person"],
                      int(s["DECODER.match_method_value"]))
    keep = match[2].repeat_interleave(J, dim=1)
    clamp_hi = (rig["centers"] * 2.0).amax(dim=(0, 2))[:, None, None]
    pm = G.projection_matrices(rig["R"], rig["T"], rig["f"], rig["c"])
    total, terms = 0.0, {}
    for lid in range(s["DECODER.num_decoder_layers"]):
        name = f"decoder.layers.{lid}"
        drop = dropout(s["DECODER.dropout"], seeds[lid], views.device)
        x, cp, attn, norm, _ = M.dq_attend(
            net, name, tgt, qpos, refs.detach(), levels, shapes, rig,
            clamp_hi, s, s["MULTI_PERSON.THRESHOLD"], train=True, drop=drop)
        new, refined = M.dq_triangulate(net, name, attn, norm, keep, rig, pm,
                                        s)
        got = layer_losses(s, M.inverse_sigmoid(cp), new, refined, frame,
                           targets, match)
        for key, weight in LOSS_WEIGHTS:
            terms[key] = terms.get(key, 0.0) + got[key]
            total = total + s[weight] * got[key]
        tgt, refs = x, new
    terms["total"] = total
    return terms


def trainable(weights: Dict[str, torch.Tensor]) -> List[str]:
    """The parameters the optimizer updates: every tensor but the frozen
    backbone's (the model's other state is all parameters)."""
    return [k for k in weights if not k.startswith("backbone.")]


class Adam:
    """The clipped two-group Adam of the measured configuration."""

    def __init__(self, spec: dict, names: List[str]):
        s = M.settings(spec)
        self.lr, self.clip = s["TRAIN.LR"], s["TRAIN.clip_max_norm"]
        self.scale = {k: (s["DECODER.lr_linear_proj_mult"]
                          if "sampling_offsets" in k
                          or "reference_points" in k else 1.0)
                      for k in names}
        self.count = 0
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        factor = 1.0 if norm < self.clip else self.clip / float(norm)
        self.count += 1
        bc1, bc2 = 1 - B1 ** self.count, 1 - B2 ** self.count
        with torch.no_grad():
            for k, g in grads.items():
                g = g * factor
                self.mu[k] = B1 * self.mu.get(k, 0.0) + (1 - B1) * g
                self.nu[k] = B2 * self.nu.get(k, 0.0) + (1 - B2) * g * g
                upd = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2)
                                            + EPS)
                params[k] -= self.lr * self.scale[k] * upd


def run_steps(spec: dict, weights: Dict[str, torch.Tensor],
              names: List[str], batches: List[tuple], seed_gen, prec):
    """`len(batches)` training steps from `weights` over (frame, targets)
    batches: each step's loss terms, the first step's gradients as the
    optimizer takes them (after the clip) and the parameters after the
    last step."""
    params = {k: v.clone() for k, v in weights.items()}
    opt = Adam(spec, names)
    steps, first = [], None
    layers = M.settings(spec)["DECODER.num_decoder_layers"]
    for frame, targets in batches:
        seeds = layer_seeds(seed_gen, layers)
        leaves = {k: params[k].requires_grad_(True) for k in names}
        net = M.Net(params, prec)
        terms = losses(spec, net, frame, targets, seeds)
        grads = torch.autograd.grad(terms["total"], list(leaves.values()),
                                    allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(params[k]))
                 for k, g in zip(leaves, grads)}
        for k in names:
            params[k] = params[k].detach()
        opt.step(params, grads)
        if first is None:
            first = {k: opt.mu[k] / (1 - B1) for k in names}
        steps.append({k: float(v.detach()) for k, v in terms.items()})
    return steps, first, params


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              floor: Dict[str, torch.Tensor]) -> List[float]:
    """Each leaf's gap between two norms: | |got| - |want| | over the
    larger of |want| and the median leaf's |want|; leaves whose reference
    gradient norm (`floor`) is under a thousandth of the median leaf's
    are left out (a gradient nought to rounding moves under Adam by
    round-off alone)."""
    def norms(d):
        return {k: float(torch.linalg.norm(v.double())) for k, v in d.items()}

    want_n, fl = norms(want), norms(floor)
    med = sorted(want_n.values())[len(want_n) // 2]
    fmed = sorted(fl.values())[len(fl) // 2]
    out = []
    for k in want_n:
        if fl[k] < 1e-3 * fmed:
            continue
        g = float(torch.linalg.norm(got[k].double()))
        gap = abs(g - want_n[k]) / max(want_n[k], med)
        out.append(gap if math.isfinite(gap) else math.inf)
    return out
