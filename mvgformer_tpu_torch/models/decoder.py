"""Dynamic-query decoder: iterative project -> attend -> refine -> triangulate.

Port of `mvgformer_tpu/models/decoder.py`: the FFN, threshold (or 'all')
query filtering, the top-K of layer 1 (selected once, in the layer; the
decoder runs the later layers on it) and point-top-m in serving; in training
(`train=True`) the gt-match query mask, dropout at JAX's sites, the
corner-table sampler, TRAIN.TRI_GRAD_CLIP and per-layer
rematerialization (PARALLEL.REMAT_DECODER), with no compaction, point-top-m
or window plan. Everything is dense with a boolean query mask: inactive
queries' outputs and next-layer reference points become zeros.

The model options of the original DQ decoder: every
DECODER.feature_update_method (`update_feature`), init_self_attention (a
self-attention over the queries before ProjAttn), triangulation_method
'st' (structural triangulation with bone-length targets), bayesian_update
(a learned blend of the triangulation with the layer's input pose) and
share_layer_weights (one `layer_shared` module run num_layers times).

Dropout draws its masks from generators seeded per layer and step, so a
layer recomputed for the backward draws the same masks; which layers drop
out is decided by the `train` argument, as in JAX, not by nn.Module.train().
The seeds are drawn from a CPU generator (`host_seeds`), so a training
step on the card reads nothing back for them.

Under view parallelism (`grid`, a `parallel.DataParallel` whose view
world is above 1) each rank holds its own views of the frame; the layer's
per-view stages (1, 3, 7, 8) run on them and the cross-view points are
collectives over the view group (`parallel/collectives.py`), per layer:
one sum all-reduce for the mean over views (4) and one all-gather of the
undistorted 2D points with the confidence logits for the softmax over
views and the triangulation (9), one more sum all-reduce with
bayesian_update; per frame, one all-gather of the projection matrices
and, with the windowed layer 1, one sum all-reduce of its escaped mass.
Everything from the mean over views on is replicated: every rank of a
data row holds the same bits and selects the same top-K queries. The 2D
outputs (refs_2d, projs_2d) stay the rank's own views. Under a data split
the per-view clamp of the projections is the max over the global batch,
one max all-reduce over the data group per frame, as JAX's program
computes it on its global batch.

Per layer:
  1. project each query's 3D joints into every view, bounds-mask, clamp,
     map to network-image coordinates;
  2. (init_self_attention) self-attention over the queries;
  3. projective attention over the per-view feature maps (ProjAttn);
  4. fuse the mean over views into the query features, then the FFN;
  5. classify queries and derive the active mask;
  6. (layer 1 with top-K) select the top-K queries for stages 7-9;
  7. per-view 2D offsets and confidences;
  8. inverse crop affine and undistortion (`dlt_jacobi.image_points`);
  9. confidence-weighted DLT (`dlt_jacobi.solve_views`) or structural
     triangulation, masked; the optional bayesian blend, masked again.

On the card a call with the Jacobi solver and every view on this process
runs steps 8-9 up to the masked points as one kernel, and in training its
backward as one more (`dlt_jacobi.fused_dlt`, rule `fused_path`); a view
split, the CPU and the other solvers call the two functions of the plain
chain.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mvgformer_tpu_torch.data.meta import ViewData
from mvgformer_tpu_torch.device import constant
from mvgformer_tpu_torch.geometry.cameras import (project_points,
                                                  projection_matrices)
from mvgformer_tpu_torch.geometry.structural import (HumanTree,
                                                     structural_triangulate)
from mvgformer_tpu_torch.geometry.transforms import apply_affine
from mvgformer_tpu_torch.models.attention import MultiheadAttention
from mvgformer_tpu_torch.models.mlp import Dense, OffsetNet
from mvgformer_tpu_torch.ops import dlt_jacobi
from mvgformer_tpu_torch.ops.projattn import ProjAttn, top_indices
from mvgformer_tpu_torch.ops.window_sampling import WindowPlan
from mvgformer_tpu_torch.parallel import collectives
from mvgformer_tpu_torch.utils.profiling import LAYER, span

# flax's nn.LayerNorm default; torch's is 1e-5
LN_EPS = 1e-6


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm with flax's epsilon and flax's precision: the
    statistics, the scale and the bias in float32 with the float32
    parameters, the result in `dtype`. (torch's bfloat16 layer_norm on the
    CPU sums the scale and bias gradients over the rows in bfloat16: 5% of
    the largest off at 15,360 rows, where flax's are float32 sums.)"""

    def __init__(self, d: int, dtype: torch.dtype = torch.float32):
        super().__init__(d, eps=LN_EPS)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.dtype)


def projection_clamp(view_data: ViewData, grid=None) -> torch.Tensor:
    """(V,) the per-view clamp of the projections: the largest width or
    height of each view over the batch, and under a data split over the
    global batch (a max all-reduce over the data group)."""
    hi = (view_data.centers * 2.0).amax(dim=(0, 2))
    return collectives.all_reduce_max(hi, grid, axis="data")


def project_reference_points(reference_points: torch.Tensor,
                             view_data: ViewData, spatial_shapes, img_size,
                             hi: torch.Tensor, detach: bool = True):
    """3D refs (B, Nq, 3) mm -> per-view normalized net-image points; with
    `detach` (DECODER.detach_refpoints_cameraprj_firstlayer) no gradient
    flows back into the refs. `hi` is the (V,) clamp of the pixels
    (`projection_clamp`).

    Returns (ref2d_norm (B, V, Nq, 2), ref2d_lvl (B, V, Nq, L, 2), bounds
    (B, V, Nq) bool)."""
    B, Nq, _ = reference_points.shape
    V = view_data.num_views
    if detach:
        reference_points = reference_points.detach()
    x = reference_points[:, None].expand(B, V, Nq, 3).float()
    pix = project_points(x, view_data.cameras)

    wh = view_data.centers * 2.0  # (B, V, 2)
    bounds = ((pix[..., 0] >= 0) & (pix[..., 1] >= 0)
              & (pix[..., 0] < wh[..., 0:1]) & (pix[..., 1] < wh[..., 1:2]))
    # per-view scalar clamp: hi = max of wh over (batch, 2)
    pix = torch.minimum(torch.clamp(pix, min=-1.0), hi[None, :, None, None])

    net = apply_affine(pix, view_data.affine)
    norm = net / constant(img_size, device=net.device)
    whl = constant([[w, h] for h, w in spatial_shapes], device=net.device)
    # per-level S/(S-1) expansion
    lvl = norm[..., None, :] * (whl / (whl - 1.0))
    return norm, lvl, bounds


def _take_queries(x: torch.Tensor, sel: torch.Tensor, num_joints: int,
                  q_axis: int) -> torch.Tensor:
    """Gather the selected queries' slices; x has a Q*J axis at q_axis and
    sel is (B, K)."""
    xq = x.movedim(q_axis, 1)
    B, QJ = xq.shape[:2]
    xq = xq.reshape((B, QJ // num_joints, num_joints) + xq.shape[2:])
    taken = xq[torch.arange(B, device=x.device)[:, None], sel]
    return taken.reshape((B, -1) + taken.shape[3:]).movedim(1, q_axis)


def _scatter_queries(x: torch.Tensor, sel: torch.Tensor, num_queries: int,
                     num_joints: int, q_axis: int) -> torch.Tensor:
    """Inverse of _take_queries: place compacted queries into dense zeros."""
    xq = x.movedim(q_axis, 1)
    B, K = sel.shape
    xq = xq.reshape((B, K, num_joints) + xq.shape[2:])
    dense = xq.new_zeros((B, num_queries) + xq.shape[2:])
    dense[torch.arange(B, device=x.device)[:, None], sel] = xq
    dense = dense.reshape((B, num_queries * num_joints) + xq.shape[3:])
    return dense.movedim(1, q_axis)


def _dropout(x: torch.Tensor, p: float,
             generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout as flax's nn.Dropout: keep with probability 1 - p,
    scale the kept values by 1 / (1 - p); the mask from `generator`."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


FEATURE_UPDATE_METHODS = ("MLP", "MLP0", "MLPr", "mean")


def host_seeds(generator: Optional[torch.Generator], n: int) -> List[int]:
    """`n` seeds drawn from `generator`, a CPU generator (the default one
    if None), so that drawing them reads nothing back from the card."""
    if generator is not None and generator.device.type != "cpu":
        raise ValueError("the training generator must be a CPU generator, "
                         f"not one on {generator.device}")
    return torch.randint(0, 2 ** 62, (n,), generator=generator).tolist()


def _drop_fn(p: float, seed: Optional[int], device):
    """The dropout of one layer: identity unless a seed is given
    (training with p > 0), else masks from a generator it seeds."""
    if seed is None:
        return lambda x: x
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return lambda x: _dropout(x, p, gen)


class DQDecoderLayer(nn.Module):
    """One iterative-geometry decoder layer (dense-masked)."""

    def __init__(self, d_model: int = 256, d_ffn: int = 1024,
                 dropout: float = 0.1,
                 n_levels: int = 1, n_heads: int = 8, n_points: int = 8,
                 img_size: Tuple[int, int] = (960, 512),
                 num_joints: int = 15, detach_refpoints: bool = True,
                 feature_update_method: str = "MLP",
                 init_self_attention: bool = False,
                 open_forward_ffn: bool = True,
                 posembed_mode: str = "ablation_not_use_rayconv",
                 triangulation_solver: str = "eigh",
                 st_bone_lengths: Optional[Sequence[float]] = None,
                 st_n_steps: int = 1,
                 bayesian_update: bool = False,
                 pose_embed_layers: int = 3,
                 tri_grad_clip: Optional[float] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        method = feature_update_method
        if not (method in FEATURE_UPDATE_METHODS
                or method.startswith("attention")):
            raise ValueError(f"unknown feature_update_method: {method}")
        if posembed_mode != "ablation_not_use_rayconv":
            # the DQ layer passes ProjAttn no camera rays (JAX's asserts)
            raise ValueError(
                f"projattn_posembed_mode {posembed_mode!r} needs camera "
                f"rays, which only the MvP baseline builds")
        if triangulation_solver == "st" and st_bone_lengths is None:
            raise ValueError("triangulation_solver 'st' needs "
                             "st_bone_lengths")
        g = generator
        self.dropout = float(dropout)
        self.img_size = tuple(img_size)
        self.num_joints = num_joints
        self.detach_refpoints = detach_refpoints
        self.feature_update_method = method
        self.open_forward_ffn = open_forward_ffn
        self.triangulation_solver = triangulation_solver
        self.st_n_steps = st_n_steps
        self.tri_grad_clip = tri_grad_clip
        if st_bone_lengths is not None:
            self.register_buffer("st_bone_lengths", torch.tensor(
                list(st_bone_lengths), dtype=torch.float32),
                persistent=False)
            self.register_buffer("st_conversion", torch.tensor(
                HumanTree().conv_B2J, dtype=torch.float32), persistent=False)
        if init_self_attention:
            self.init_self_attn = MultiheadAttention(d_model, n_heads, dtype,
                                                     generator=g)
            self.norm_init = LayerNorm(d_model, dtype)
        self.proj_attn = ProjAttn(d_model, n_levels, n_heads, n_points,
                                  dtype=dtype, generator=g)
        if method == "mean":
            self.norm1 = LayerNorm(d_model, dtype)
        elif method.startswith("attention"):
            self.self_attn = MultiheadAttention(d_model, n_heads, dtype,
                                                generator=g)
            self.norm2 = LayerNorm(d_model, dtype)
        else:
            self.feature_update_mlp = Dense(d_model, d_model, dtype,
                                            generator=g)
            if method == "MLP":
                self.norm2 = LayerNorm(d_model, dtype)
        if open_forward_ffn:
            self.linear1 = Dense(d_model, d_ffn, dtype, generator=g)
            self.linear2 = Dense(d_ffn, d_model, dtype, generator=g)
            self.norm3 = LayerNorm(d_model, dtype)
        self.class_embed = Dense(d_model, 2, dtype, generator=g)
        self.pose_embed = OffsetNet(d_model, pose_embed_layers, dtype,
                                    generator=g)
        if bayesian_update:
            self.bayesian_conf = Dense(d_model, 1, dtype, generator=g)

    def update_feature(self, tgt, attn_mean, query_pos, drop):
        """Fuse the view-mean features (B, Nq, C) into the query
        features by DECODER.feature_update_method."""
        method = self.feature_update_method
        if method == "mean":
            # the mean over the QUERY axis, as the original code has it
            return self.norm1(tgt + drop(attn_mean.mean(dim=1,
                                                        keepdim=True)))
        if method.startswith("attention"):
            # q = k = the features (+ pos for the 'embed' variants); the
            # value is tgt for plain 'attention', the original code's
            # acknowledged bug, kept for checkpoint compatibility
            q = (attn_mean if query_pos is None or "embed" not in method
                 else attn_mean + query_pos)
            value = tgt if method == "attention" else attn_mean
            attn = self.self_attn(q, q, value)
            if method.endswith("direct"):
                return self.norm2(drop(attn))
            return self.norm2(tgt + drop(attn))
        tgt2 = self.feature_update_mlp(attn_mean)
        if method == "MLP0":
            return tgt2
        if method == "MLPr":
            return tgt + drop(tgt2)
        return self.norm2(tgt + drop(tgt2))

    def forward(self, tgt: torch.Tensor, query_pos: Optional[torch.Tensor],
                reference_points: torch.Tensor,
                src_views: Sequence[torch.Tensor], spatial_shapes,
                view_data: ViewData, proj_mats: torch.Tensor,
                clamp_hi: torch.Tensor, threshold: float = 0.5,
                filter_method: str = "threshold",
                triangulate_topk: Optional[int] = None,
                window_plan: Optional[WindowPlan] = None,
                offset_clamp: Optional[float] = None,
                point_topm: Optional[int] = None,
                query_mask: Optional[torch.Tensor] = None,
                train: bool = False,
                dropout_seed: Optional[int] = None,
                taps: Optional[dict] = None,
                grid=None):
        """
        Args:
            tgt:              (B, Nq, C) query features, Nq = Q * J.
            query_pos:        (B, Nq, C) or None.
            reference_points: (B, Nq, 3) absolute mm.
            src_views:        list of (V*B, h, w, C) maps (view-major
                              fold), finest first.
            view_data:        cameras and crops, fields (B, V, ...).
            proj_mats:        (B, V, 3, 4) every view's projection
                              matrices, computed and (under a view split)
                              gathered once per frame by DQDecoder.
            clamp_hi:         (V,) the projection clamp
                              (`projection_clamp`), once per frame.
            window_plan:      rig-static plan of the windowed sampler
                              (layer 1 only).
            offset_clamp:     clamp of the learned sampling offsets, px
                              (layer 1 only).
            query_mask:       (B, Q) bool active queries (the gt match in
                              training); None derives it from the class
                              probability and `filter_method`.
            train:            the training forward: dropout, the corner
                              sampler, no top-K.
            dropout_seed:     seed of this layer's dropout masks (train).
            taps:             ProjAttn's debug taps (`ProjAttn.forward`).
            grid:             the (data x view) grid under view
                              parallelism (view_data and src_views then
                              hold this rank's views), or None.
        Returns:
            (tgt_update, new_refs (B, Nqc, 3), refined_2d (B, V, Nqc, 2),
             projs_2d (B, V, Nqc, 2), class_prob (B, Q, 2), escaped mass of
             the windowed sampler or None, sel): sel (B, K) the top-K queries
             that steps 7-9 ran on (Nqc = K * J), or None (Nqc = Nq)
        """
        B, Nq, C = tgt.shape
        V = view_data.num_views  # this rank's views
        split = collectives.axis_size(grid) > 1
        J = self.num_joints
        Q = Nq // J
        img_wh = constant(self.img_size, device=tgt.device)
        seed = None
        if train and self.dropout > 0.0:
            if dropout_seed is None:
                raise ValueError("training with dropout needs a dropout_seed")
            seed = dropout_seed
        drop = _drop_fn(self.dropout, seed, tgt.device)

        # (1) project the query joints into every view
        with span("mvg.project"):
            ref_norm, ref_lvl, bounds = project_reference_points(
                reference_points, view_data, spatial_shapes, self.img_size,
                clamp_hi, detach=self.detach_refpoints)

        # (2) the optional self-attention over the queries; its result
        # feeds ProjAttn only, update_feature's residual stays tgt
        tgt_for_attn = tgt
        if hasattr(self, "init_self_attn"):
            q = tgt if query_pos is None else tgt + query_pos
            tgt_for_attn = self.norm_init(
                tgt + drop(self.init_self_attn(q, q, tgt)))

        # (3) projective attention, views folded view-major (v*B + b)
        q_in = (tgt_for_attn if query_pos is None
                else tgt_for_attn + query_pos)
        q_fold = q_in[None].expand(V, B, Nq, C).reshape(V * B, Nq, C)
        ref_fold = ref_lvl.transpose(0, 1).reshape(
            V * B, Nq, len(spatial_shapes), 2)
        attn, escaped = self.proj_attn(
            q_fold, ref_fold, src_views, spatial_shapes,
            window_plan=window_plan, offset_clamp_px=offset_clamp,
            point_topm=point_topm, train=train, taps=taps)
        attn = attn.reshape(V, B, Nq, C)
        # zero features whose projection fell outside the image
        attn = attn * bounds.transpose(0, 1)[..., None].to(attn.dtype)

        # (4) fuse the view mean into the query features, then the FFN
        # (dropout after the ReLU and after linear2); under a view split
        # the mean is a float32 sum all-reduce, rounded to attn's dtype
        # once, as the single process's mean is
        tgt_update = self.update_feature(
            tgt, collectives.view_mean(attn, grid), query_pos, drop)
        if self.open_forward_ffn:
            x = self.linear2(drop(F.relu(self.linear1(tgt_update))))
            tgt_update = self.norm3(tgt_update + drop(x))

        # (5) classify; the active-query mask
        prob = torch.sigmoid(self.class_embed(tgt_update).float())
        class_prob = prob.reshape(B, Q, J, 2).mean(dim=2)  # (B, Q, 2)
        if query_mask is None:
            if filter_method == "all":
                query_mask = torch.ones((B, Q), dtype=torch.bool,
                                        device=tgt.device)
            elif filter_method == "threshold":
                query_mask = class_prob[..., 1] > threshold
            else:
                raise ValueError(filter_method)
        mask_nq = query_mask.repeat_interleave(J, dim=1)  # (B, Nq)

        # (6) layer 1's top-K: stages 7-9 run on these queries alone
        sel = None
        if (triangulate_topk is not None and not train
                and triangulate_topk < Q):
            with span("mvg.topk"):
                sel = top_indices(class_prob[..., 1], triangulate_topk)
                attn = _take_queries(attn.transpose(0, 1), sel, J,
                                     2).transpose(0, 1)
                ref_norm = _take_queries(ref_norm, sel, J, 2)
                mask_nq = _take_queries(mask_nq, sel, J, 1)
                reference_points = _take_queries(reference_points, sel, J,
                                                 1)

        # (7) per-view offsets + confidences
        out2d, conf_logits = self.pose_embed(attn)
        ref_norm_v = ref_norm.transpose(0, 1)  # (V, B, Nqc, 2)
        refined_abs = (ref_norm_v + out2d.float() / img_wh) * img_wh
        projs_abs = ref_norm_v * img_wh
        conf_logits = conf_logits.float()

        with span("mvg.dlt"):
            if dlt_jacobi.fused_path(refined_abs.device,
                                     self.triangulation_solver, split):
                # (8-9) one kernel on the card: the Jacobi DLT from the
                # refined points to the masked new refs (in training, one
                # more for its backward)
                new_refs = dlt_jacobi.fused_dlt(
                    refined_abs, conf_logits, mask_nq, view_data.inv_affine,
                    view_data.cameras, proj_mats,
                    self.tri_grad_clip if train else None)
            else:
                # (8) masked-out queries triangulate the image centre
                points = dlt_jacobi.image_points(
                    refined_abs, mask_nq, img_wh * 0.5, view_data.inv_affine,
                    view_data.cameras)
                if split:
                    # the softmax over views and the solve need every view: one
                    # all-gather of the points and the logits, in view order
                    packed = collectives.all_gather(torch.cat(
                        [points, conf_logits.transpose(0, 1)[..., None]],
                        dim=-1), grid, dim=1)  # (B, V, Nqc, 3)
                    points = packed[..., :2]
                    conf_logits = packed[..., 2].transpose(0, 1)
                # (9) triangulate, zeros for the masked-out queries
                if self.triangulation_solver == "st":
                    # structural triangulation, one person P per query
                    V, Nqc = points.shape[1:3]
                    P = B * Nqc // J
                    conf = torch.softmax(conf_logits, dim=0)
                    pts_p = points.transpose(1, 2).reshape(
                        P, J, V, 2).transpose(1, 2)  # (P, V, J, 2)
                    conf_p = conf.permute(1, 2, 0).reshape(
                        P, J, V).transpose(1, 2)  # (P, V, J)
                    pm_p = proj_mats[:, None].expand(
                        B, Nqc // J, V, 3, 4).reshape(P, V, 3, 4)
                    lengths = self.st_bone_lengths[None].expand(P, J - 1)
                    new_refs = structural_triangulate(
                        pm_p, pts_p, conf_p, lengths, n_steps=self.st_n_steps,
                        conversion=self.st_conversion).reshape(B, Nqc, 3)
                    new_refs = torch.where(mask_nq[..., None], new_refs, 0.0)
                else:
                    new_refs = dlt_jacobi.solve_views(
                        points, conf_logits, mask_nq, proj_mats,
                        self.triangulation_solver,
                        self.tri_grad_clip if train else None)
            if hasattr(self, "bayesian_conf"):
                # blend with the layer's input pose by a learned confidence,
                # which brings the masked-out queries back: zero them again
                bconf = collectives.view_mean(torch.sigmoid(
                    self.bayesian_conf(attn)), grid).float()  # (B, Nqc, 1)
                new_refs = torch.where(
                    mask_nq[..., None],
                    bconf * new_refs + (1 - bconf) * reference_points.float(),
                    0.0)
            m4 = mask_nq[:, None, :, None]
            refined_out = torch.where(m4, refined_abs.transpose(0, 1), 0.0)
            projs_out = torch.where(m4, projs_abs.transpose(0, 1), 0.0)
        return (tgt_update, new_refs, refined_out, projs_out, class_prob,
                escaped, sel)

class DQDecoder(nn.Module):
    """Stack of decoder layers collecting per-layer outputs.

    topk_queries: the first layer selects the top-K queries by class
    score and runs its steps 7-9 on them; the later layers run on them
    alone. What ran compacted is scattered back to dense here (dropped
    queries read as zeros).

    window_plan and layer1_offset_clamp reach the first layer only, whose
    sampling centers are the static grid; the first layer's output dict
    then carries the windowed sampler's "escaped_mass".

    In training (`train=True`) the top-K, the window plan, the offset clamp
    and point-top-m are off, as in JAX; with `remat` each layer runs under
    torch.utils.checkpoint and is recomputed in the backward.

    share_layer_weights: one `layer_shared` layer runs num_layers times.

    grid: under view parallelism the layers run on this rank's views
    (the module docstring's collectives); the projection matrices of every
    view are gathered once per frame, and the projection clamp is reduced
    over the data group once per frame under a data split.

    ref_clamp_box: an optional (x_lo, y_lo, z_lo, x_hi, y_hi, z_hi) mm box
    (DECODER.clamp_refs_to_space) into which each layer's reference points
    are clipped before the next layer takes them. A stabilizer for
    from-scratch training: early triangulations of near-parallel rays fly
    to ~1e6 mm and each layer amplifies the previous one's. The layer
    outputs, and so the loss, keep the raw predictions."""

    def __init__(self, num_layers: int, num_joints: int, remat: bool = False,
                 share_layer_weights: bool = False,
                 ref_clamp_box: Optional[Tuple[float, ...]] = None,
                 **layer_kwargs):
        super().__init__()
        self.num_joints = num_joints
        self.remat = remat
        self.ref_clamp_box = ref_clamp_box
        if share_layer_weights:
            self.layer_shared = DQDecoderLayer(num_joints=num_joints,
                                               **layer_kwargs)
            self.stack = [self.layer_shared] * num_layers
        else:
            self.layers = nn.ModuleList(
                DQDecoderLayer(num_joints=num_joints, **layer_kwargs)
                for _ in range(num_layers))
            self.stack = list(self.layers)

    def forward(self, tgt, query_pos, reference_points, src_views,
                spatial_shapes, view_data, threshold=0.5,
                filter_method="threshold", topk_queries=None,
                window_plan=None, layer1_offset_clamp=None,
                point_topm=None, query_mask=None, train=False,
                generator: Optional[torch.Generator] = None,
                intermediates: Optional[dict] = None, grid=None):
        """`generator` draws one dropout seed per layer in training (the
        default generator if None). `intermediates`, where given, receives
        each layer's ProjAttn debug taps under
        {layer name: {"proj_attn": {...}}}, the layer name `layer_{l}` or,
        with shared weights, `layer_shared` (every call appended), as JAX
        sows them; not in training."""
        if intermediates is not None and train:
            raise ValueError("the debug taps are for the serving forward")
        J = self.num_joints
        Q = tgt.shape[1] // J
        seeds = [None] * len(self.stack)
        if train:
            topk_queries = window_plan = layer1_offset_clamp = None
            point_topm = None
            if self.stack[0].dropout > 0.0:
                seeds = host_seeds(generator, len(self.stack))
        outputs = []
        out, qpos, refs, sel = tgt, query_pos, reference_points, None
        box = self.ref_clamp_box
        if box is not None:
            lo = constant(box[:3], device=tgt.device)
            hi = constant(box[3:], device=tgt.device)
        # once per frame: the clamp over the global batch, every view's
        # projection matrices
        clamp_hi = projection_clamp(view_data, grid)
        proj_mats = collectives.all_gather(
            projection_matrices(view_data.cameras, inv_trans=True), grid,
            dim=1)

        def dense(x, key):
            """An output computed on the top-K queries `sel`, scattered back
            to dense: the dropped queries read as zeros."""
            return _scatter_queries(x, sel, Q, 1 if key == "class_prob" else J,
                                    2 if key.endswith("_2d") else 1)

        for lid, layer in enumerate(self.stack):
            with span(LAYER.format(lid)):
                kwargs = dict(
                    threshold=threshold, filter_method=filter_method,
                    triangulate_topk=topk_queries if lid == 0 else None,
                    window_plan=window_plan if lid == 0 else None,
                    offset_clamp=layer1_offset_clamp if lid == 0 else None,
                    point_topm=point_topm, query_mask=query_mask, train=train,
                    dropout_seed=seeds[lid], grid=grid)
                if intermediates is not None:
                    name = ("layer_shared" if hasattr(self, "layer_shared")
                            else f"layer_{lid}")
                    kwargs["taps"] = intermediates.setdefault(
                        name, {}).setdefault("proj_attn", {})
                args = (out, qpos, refs, src_views, spatial_shapes,
                        view_data, proj_mats, clamp_hi)
                if not (train and self.remat):
                    res = layer(*args, **kwargs)
                else:
                    res = checkpoint(layer, *args, use_reentrant=False,
                                     **kwargs)
                out, refs, ref2d, projs2d, class_prob, escaped, selected = res
                outs = {"hs": out, "refs": refs, "refs_2d": ref2d,
                        "projs_2d": projs2d, "class_prob": class_prob}
                if selected is not None:
                    with span("mvg.topk"):
                        # layer 1 ran steps 7-9 on its top-K queries; the
                        # later layers run on them alone
                        sel = selected
                        for key in ("refs", "refs_2d", "projs_2d"):
                            outs[key] = dense(outs[key], key)
                        out = _take_queries(out, sel, J, 1)
                        if qpos is not None:
                            qpos = _take_queries(qpos, sel, J, 1)
                        if query_mask is not None:
                            query_mask = torch.gather(query_mask, 1, sel)
                elif sel is not None:
                    outs = {key: dense(x, key) for key, x in outs.items()}
                if escaped is not None:
                    outs["escaped_mass"] = collectives.all_reduce_sum(escaped,
                                                                      grid)
                outputs.append(outs)
                if box is not None:
                    # bound only the next layer's input; the outputs above
                    # keep the raw predictions
                    refs = torch.clamp(refs, lo, hi)
        return outputs
