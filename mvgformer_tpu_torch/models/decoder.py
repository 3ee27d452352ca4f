"""Dynamic-query decoder: iterative project -> attend -> refine -> triangulate.

Port of `mvgformer_tpu/models/decoder.py` for feature_update_method 'MLP':
the FFN, threshold (or 'all') query filtering, the in-layer top-K of layer
1, the decoder-level top-K compaction of the later layers and point-top-m
in serving; in training (`train=True`) the gt-match query mask, dropout at
JAX's sites (dropout2-4), the corner-table sampler, TRAIN.TRI_GRAD_CLIP and
per-layer rematerialization (PARALLEL.REMAT_DECODER), with no compaction,
point-top-m or window plan. Everything is dense with a boolean query mask:
inactive queries' outputs and next-layer reference points become zeros.

Dropout draws its masks from a generator seeded per layer and step, so a
layer recomputed for the backward draws the same masks; which layers drop
out is decided by the `train` argument, as in JAX, not by nn.Module.train().

Per layer:
  1. project each query's 3D joints into every view, bounds-mask, clamp,
     map to network-image coordinates;
  2. projective attention over the per-view feature maps (ProjAttn);
  3. fuse the mean over views into the query features, then the FFN;
  4. classify queries and derive the active mask;
  5. (layer 1 with top-K) keep the top-K queries for stages 6-8;
  6. per-view 2D offsets and confidences;
  7. inverse crop affine and undistortion;
  8. confidence-weighted DLT triangulation, masked dense update.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mvgformer_tpu_torch.data.meta import ViewData
from mvgformer_tpu_torch.geometry.cameras import (project_points,
                                                  projection_matrices,
                                                  undistort_points)
from mvgformer_tpu_torch.geometry.transforms import apply_affine
from mvgformer_tpu_torch.geometry.triangulate import (clip_cotangent,
                                                      triangulate_dlt)
from mvgformer_tpu_torch.models.mlp import Dense, OffsetNet
from mvgformer_tpu_torch.ops.projattn import ProjAttn, top_indices
from mvgformer_tpu_torch.ops.window_sampling import WindowPlan

# flax's nn.LayerNorm default; torch's is 1e-5
LN_EPS = 1e-6


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm with flax's epsilon, computing in `dtype`."""

    def __init__(self, d: int, dtype: torch.dtype = torch.float32):
        super().__init__(d, eps=LN_EPS)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.to(self.dtype), self.normalized_shape,
                            self.weight.to(self.dtype),
                            self.bias.to(self.dtype), self.eps)


def project_reference_points(reference_points: torch.Tensor,
                             view_data: ViewData, spatial_shapes, img_size,
                             detach: bool = True):
    """3D refs (B, Nq, 3) mm -> per-view normalized net-image points; with
    `detach` (DECODER.detach_refpoints_cameraprj_firstlayer) no gradient
    flows back into the refs.

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
    hi = wh.amax(dim=(0, 2))  # (V,)
    pix = torch.minimum(torch.clamp(pix, min=-1.0), hi[None, :, None, None])

    net = apply_affine(pix, view_data.affine)
    norm = net / torch.tensor(img_size, dtype=torch.float32,
                              device=net.device)
    whl = torch.tensor([[w, h] for h, w in spatial_shapes],
                       dtype=torch.float32, device=net.device)
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


class DQDecoderLayer(nn.Module):
    """One iterative-geometry decoder layer (dense-masked)."""

    def __init__(self, d_model: int = 256, d_ffn: int = 1024,
                 dropout: float = 0.1,
                 n_levels: int = 1, n_heads: int = 8, n_points: int = 8,
                 img_size: Tuple[int, int] = (960, 512),
                 num_joints: int = 15, detach_refpoints: bool = True,
                 open_forward_ffn: bool = True,
                 triangulation_solver: str = "eigh",
                 pose_embed_layers: int = 3,
                 tri_grad_clip: Optional[float] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.dropout = float(dropout)
        self.img_size = tuple(img_size)
        self.num_joints = num_joints
        self.detach_refpoints = detach_refpoints
        self.open_forward_ffn = open_forward_ffn
        self.triangulation_solver = triangulation_solver
        self.tri_grad_clip = tri_grad_clip
        self.proj_attn = ProjAttn(d_model, n_levels, n_heads, n_points,
                                  dtype=dtype, generator=g)
        self.feature_update_mlp = Dense(d_model, d_model, dtype, generator=g)
        self.norm2 = LayerNorm(d_model, dtype)
        if open_forward_ffn:
            self.linear1 = Dense(d_model, d_ffn, dtype, generator=g)
            self.linear2 = Dense(d_ffn, d_model, dtype, generator=g)
            self.norm3 = LayerNorm(d_model, dtype)
        self.class_embed = Dense(d_model, 2, dtype, generator=g)
        self.pose_embed = OffsetNet(d_model, pose_embed_layers, dtype,
                                    generator=g)

    def forward(self, tgt: torch.Tensor, query_pos: Optional[torch.Tensor],
                reference_points: torch.Tensor,
                src_views: Sequence[torch.Tensor], spatial_shapes,
                view_data: ViewData, threshold: float = 0.5,
                filter_method: str = "threshold",
                triangulate_topk: Optional[int] = None,
                window_plan: Optional[WindowPlan] = None,
                offset_clamp: Optional[float] = None,
                point_topm: Optional[int] = None,
                query_mask: Optional[torch.Tensor] = None,
                train: bool = False,
                dropout_seed: Optional[int] = None):
        """
        Args:
            tgt:              (B, Nq, C) query features, Nq = Q * J.
            query_pos:        (B, Nq, C) or None.
            reference_points: (B, Nq, 3) absolute mm.
            src_views:        list of (V*B, h, w, C) maps (view-major
                              fold), finest first.
            view_data:        cameras and crops, fields (B, V, ...).
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
        Returns:
            (tgt_update, new_refs (B, Nq, 3), refined_2d (B, V, Nq, 2),
             projs_2d (B, V, Nq, 2), class_prob (B, Q, 2), escaped mass of
             the windowed sampler or None)
        """
        B, Nq, C = tgt.shape
        V = view_data.num_views
        J = self.num_joints
        Q = Nq // J
        img_wh = torch.tensor(self.img_size, dtype=torch.float32,
                              device=tgt.device)
        drop_gen = None
        if train and self.dropout > 0.0:
            if dropout_seed is None:
                raise ValueError("training with dropout needs a dropout_seed")
            drop_gen = torch.Generator(device=tgt.device)
            drop_gen.manual_seed(int(dropout_seed))

        def drop(x):
            return x if drop_gen is None else _dropout(x, self.dropout,
                                                       drop_gen)

        # (1) project the query joints into every view
        ref_norm, ref_lvl, bounds = project_reference_points(
            reference_points, view_data, spatial_shapes, self.img_size,
            detach=self.detach_refpoints)

        # (2) projective attention, views folded view-major (v*B + b)
        q_in = tgt if query_pos is None else tgt + query_pos
        q_fold = q_in[None].expand(V, B, Nq, C).reshape(V * B, Nq, C)
        ref_fold = ref_lvl.transpose(0, 1).reshape(
            V * B, Nq, len(spatial_shapes), 2)
        attn, escaped = self.proj_attn(
            q_fold, ref_fold, src_views, spatial_shapes,
            window_plan=window_plan, offset_clamp_px=offset_clamp,
            point_topm=point_topm, train=train)
        attn = attn.reshape(V, B, Nq, C)
        # zero features whose projection fell outside the image
        attn = attn * bounds.transpose(0, 1)[..., None].to(attn.dtype)

        # (3) fuse the view mean into the query features (dropout2), then
        # the FFN (dropout3 after the ReLU, dropout4 after linear2)
        tgt_update = self.norm2(tgt + drop(self.feature_update_mlp(
            attn.mean(dim=0))))
        if self.open_forward_ffn:
            x = self.linear2(drop(F.relu(self.linear1(tgt_update))))
            tgt_update = self.norm3(tgt_update + drop(x))

        # (4) classify; the active-query mask
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

        # (5) in-layer compaction: stages 6-8 run on the top-K queries
        sel = None
        Nqc = Nq
        if (triangulate_topk is not None and not train
                and triangulate_topk < Q):
            sel = top_indices(class_prob[..., 1], triangulate_topk)
            Nqc = triangulate_topk * J
            attn = _take_queries(attn.transpose(0, 1), sel, J,
                                 2).transpose(0, 1)
            ref_norm = _take_queries(ref_norm, sel, J, 2)
            mask_nq = _take_queries(mask_nq, sel, J, 1)

        # (6) per-view offsets + confidences
        out2d, conf_logits = self.pose_embed(attn)
        ref_norm_v = ref_norm.transpose(0, 1)  # (V, B, Nqc, 2)
        refined_abs = (ref_norm_v + out2d.float() / img_wh) * img_wh
        projs_abs = ref_norm_v * img_wh
        conf = torch.softmax(conf_logits.float(), dim=0)

        # (7) masked-out queries triangulate the image centre, a safe
        # stand-in, before the inverse affine and undistortion
        tri_in = torch.where(mask_nq[None, :, :, None], refined_abs,
                             img_wh * 0.5)
        orig = apply_affine(tri_in.transpose(0, 1), view_data.inv_affine)
        orig_undist = undistort_points(orig, view_data.cameras, iter_num=5)
        proj_mats = projection_matrices(view_data.cameras, inv_trans=True)

        # (8) triangulate, then the masked dense update
        pts = orig_undist.transpose(1, 2)  # (B, Nqc, V, 2)
        conf_bqv = conf.permute(1, 2, 0)  # (B, Nqc, V)
        if train and self.tri_grad_clip is not None:
            # TRAIN.TRI_GRAD_CLIP: bound the solver-amplified cotangents
            # reaching the offset net and the confidence head
            pts = clip_cotangent(pts, self.tri_grad_clip)
            conf_bqv = clip_cotangent(conf_bqv[..., None],
                                      self.tri_grad_clip)[..., 0]
        pm = proj_mats[:, None].expand(B, Nqc, V, 3, 4)
        new_refs = triangulate_dlt(pm, pts, conf_bqv,
                                   solver=self.triangulation_solver)
        new_refs = torch.where(mask_nq[..., None], new_refs, 0.0)
        m4 = mask_nq[:, None, :, None]
        refined_out = torch.where(m4, refined_abs.transpose(0, 1), 0.0)
        projs_out = torch.where(m4, projs_abs.transpose(0, 1), 0.0)
        if sel is not None:
            new_refs = _scatter_queries(new_refs, sel, Q, J, 1)
            refined_out = _scatter_queries(refined_out, sel, Q, J, 2)
            projs_out = _scatter_queries(projs_out, sel, Q, J, 2)
        return (tgt_update, new_refs, refined_out, projs_out, class_prob,
                escaped)


class DQDecoder(nn.Module):
    """Stack of decoder layers collecting per-layer outputs.

    topk_queries: after the first layer keep the top-K queries by class
    score and run the later layers compacted; their outputs are scattered
    back to dense (dropped queries read as zeros).

    window_plan and layer1_offset_clamp reach the first layer only, whose
    sampling centers are the static grid; the first layer's output dict
    then carries the windowed sampler's "escaped_mass".

    In training (`train=True`) the top-K, the window plan, the offset clamp
    and point-top-m are off, as in JAX; with `remat` each layer runs under
    torch.utils.checkpoint and is recomputed in the backward.

    ref_clamp_box: an optional (x_lo, y_lo, z_lo, x_hi, y_hi, z_hi) mm box
    (DECODER.clamp_refs_to_space) into which each layer's reference points
    are clipped before the next layer takes them. A stabilizer for
    from-scratch training: early triangulations of near-parallel rays fly
    to ~1e6 mm and each layer amplifies the previous one's. The layer
    outputs, and so the loss, keep the raw predictions."""

    def __init__(self, num_layers: int, num_joints: int, remat: bool = False,
                 ref_clamp_box: Optional[Tuple[float, ...]] = None,
                 **layer_kwargs):
        super().__init__()
        self.num_joints = num_joints
        self.remat = remat
        self.ref_clamp_box = ref_clamp_box
        self.layers = nn.ModuleList(
            DQDecoderLayer(num_joints=num_joints, **layer_kwargs)
            for _ in range(num_layers))

    def forward(self, tgt, query_pos, reference_points, src_views,
                spatial_shapes, view_data, threshold=0.5,
                filter_method="threshold", topk_queries=None,
                window_plan=None, layer1_offset_clamp=None,
                point_topm=None, query_mask=None, train=False,
                generator: Optional[torch.Generator] = None):
        """`generator` draws one dropout seed per layer in training (the
        default generator if None)."""
        J = self.num_joints
        Q = tgt.shape[1] // J
        seeds = [None] * len(self.layers)
        if train:
            topk_queries = window_plan = layer1_offset_clamp = None
            point_topm = None
            if self.layers[0].dropout > 0.0:
                dev = generator.device if generator is not None else "cpu"
                seeds = torch.randint(0, 2 ** 62, (len(self.layers),),
                                      generator=generator,
                                      device=dev).tolist()
        outputs = []
        out, qpos, refs, sel = tgt, query_pos, reference_points, None
        box = self.ref_clamp_box
        if box is not None:
            lo = torch.tensor(box[:3], dtype=torch.float32, device=tgt.device)
            hi = torch.tensor(box[3:], dtype=torch.float32, device=tgt.device)
        for lid, layer in enumerate(self.layers):
            run = layer
            if train and self.remat:
                def run(*args, _layer=layer, **kwargs):
                    return checkpoint(_layer, *args, use_reentrant=False,
                                      **kwargs)
            out, refs, ref2d, projs2d, class_prob, escaped = run(
                out, qpos, refs, src_views, spatial_shapes, view_data,
                threshold=threshold, filter_method=filter_method,
                triangulate_topk=topk_queries if lid == 0 else None,
                window_plan=window_plan if lid == 0 else None,
                offset_clamp=layer1_offset_clamp if lid == 0 else None,
                point_topm=point_topm, query_mask=query_mask, train=train,
                dropout_seed=seeds[lid])
            if sel is None:
                outputs.append({"hs": out, "refs": refs, "refs_2d": ref2d,
                                "projs_2d": projs2d,
                                "class_prob": class_prob})
                if escaped is not None:
                    outputs[-1]["escaped_mass"] = escaped
            else:
                outputs.append({
                    "hs": _scatter_queries(out, sel, Q, J, 1),
                    "refs": _scatter_queries(refs, sel, Q, J, 1),
                    "refs_2d": _scatter_queries(ref2d, sel, Q, J, 2),
                    "projs_2d": _scatter_queries(projs2d, sel, Q, J, 2),
                    "class_prob": _scatter_queries(class_prob, sel, Q, 1,
                                                   1),
                })
            if box is not None:
                # bound only the next layer's input; the outputs above keep
                # the raw predictions
                refs = torch.clamp(refs, lo, hi)
            if (topk_queries is not None and sel is None and lid == 0
                    and topk_queries < Q):
                sel = top_indices(class_prob[..., 1], topk_queries)
                out = _take_queries(out, sel, J, 1)
                refs = _take_queries(refs, sel, J, 1)
                if qpos is not None:
                    qpos = _take_queries(qpos, sel, J, 1)
                if query_mask is not None:
                    query_mask = torch.gather(query_mask, 1, sel)
        return outputs
