"""The MvP baseline: regression decoder and top model, no triangulation.

Port of `mvgformer_tpu/models/mvp_decoder.py` (TRANSFORMER:
multi_view_pose_transformer). Per layer: self-attention over the queries,
projection of the normalized 3D refs into every view (bounds mask, clip to
[-1, max(wh)]), projective attention over every view at once (B1 in
serving, B2 / B3 in training), the bounds-masked fusion of the views by
DECODER.fuse_view_feats, then the FFN. The 3D update is a per-layer
`pose_embed` MLP added in inverse-sigmoid space, with a per-layer
`class_embed`.

fuse_view_feats:
  * 'mean':               the mean over views;
  * 'cat_proj':           the views concatenated, projected to d_model by
                          `fuse_view_projection` (CAMERA_NUM x d_model
                          inputs, fixed from the config);
  * 'sum_proj':           the sum over views, projected;
  * 'attn_fuse_dot_prod': views weighted by softmax over views of their dot
                          product with the query;
  * 'attn_fuse_subtract': views weighted by `attn_proj` of their
                          difference from the query.

Under view parallelism (`grid`, a `parallel.DataParallel` whose view
world is above 1) each rank projects into, attends over and embeds the
rays of its own views; the fusion crosses views per layer
(`parallel/collectives.py`): 'mean' and 'sum_proj' are one float32 sum
all-reduce of the local sums; 'attn_fuse_subtract' one of the local
weighted sums; 'attn_fuse_dot_prod' all-gathers the (V, B, Nq) logits
for the softmax over views, then sums the local weighted views; and
'cat_proj' splits `fuse_view_projection` by view: each rank multiplies
its views' features by its views' columns of the weight, one sum
all-reduce adds the partial products and the bias is added once after
it. That moves one (B, Nq, C) buffer per layer where an all-gather of the
views would move V of them, and the matmul splits with the views. The
clip of the projections stays the largest width or height of the rank's
own frames and views, where JAX's program takes it over the global batch
and every view: it moves only projections that lie outside their image,
whose features the bounds mask zeroes, so either clip gives the same
output. The query-adaptation head all-gathers the pooled features once
per frame.
Everything after the fusion is replicated over a data row.

DECODER.projattn_posembed_mode 'use_rayconv' (camera rays) and
'use_2d_coordconv' (2D coordinates) build their per-pixel embeddings once
per frame, for every layer. DECODER.query_adaptation adds a head on the
pooled features of every view and level to the initial refs.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mvgformer_tpu_torch.config import Config
from mvgformer_tpu_torch.data.meta import Batch, ViewData
from mvgformer_tpu_torch.device import compute_dtype, resolve_device
from mvgformer_tpu_torch.geometry.cameras import calib_matrix, project_points
from mvgformer_tpu_torch.geometry.transforms import (apply_affine,
                                                     norm2absolute)
from mvgformer_tpu_torch.models.attention import MultiheadAttention
from mvgformer_tpu_torch.models.decoder import (LayerNorm, _drop_fn,
                                                host_seeds)
from mvgformer_tpu_torch.models.mlp import MLP, Dense
from mvgformer_tpu_torch.models.mvgformer import (feature_spatial_shapes,
                                                  inverse_sigmoid,
                                                  pooled_view_features)
from mvgformer_tpu_torch.models.pose_resnet import PoseResNet
from mvgformer_tpu_torch.models.position_encoding import (crop_intrinsics,
                                                          get_2d_coords,
                                                          get_rays)
from mvgformer_tpu_torch.ops.projattn import ProjAttn
from mvgformer_tpu_torch.parallel import collectives
from mvgformer_tpu_torch.utils.profiling import LAYER, span

FUSE_VIEW_FEATS = ("mean", "cat_proj", "sum_proj", "attn_fuse_dot_prod",
                   "attn_fuse_subtract")


class MvPDecoderLayer(nn.Module):
    """One MvP decoder layer; returns the updated query features."""

    def __init__(self, d_model: int = 256, d_ffn: int = 1024,
                 dropout: float = 0.1, n_levels: int = 1, n_heads: int = 8,
                 n_points: int = 8, img_size: Tuple[int, int] = (960, 512),
                 space_size: Sequence[float] = (8000.0, 8000.0, 2000.0),
                 space_center: Sequence[float] = (0.0, -500.0, 800.0),
                 detach_refpoints: bool = True,
                 fuse_view_feats: str = "cat_proj", n_views: int = 5,
                 posembed_mode: str = "use_rayconv",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if fuse_view_feats not in FUSE_VIEW_FEATS:
            raise ValueError(f"unknown fuse_view_feats {fuse_view_feats!r}")
        g = generator
        self.dropout = float(dropout)
        self.img_size = tuple(img_size)
        self.space_size, self.space_center = space_size, space_center
        self.detach_refpoints = detach_refpoints
        self.fuse_view_feats = fuse_view_feats
        self.n_views = n_views
        self.self_attn = MultiheadAttention(d_model, n_heads, dtype,
                                            generator=g)
        self.norm2 = LayerNorm(d_model, dtype)
        self.proj_attn = ProjAttn(d_model, n_levels, n_heads, n_points,
                                  posembed_mode=posembed_mode, dtype=dtype,
                                  generator=g)
        if fuse_view_feats == "cat_proj":
            self.fuse_view_projection = Dense(n_views * d_model, d_model,
                                              dtype, generator=g)
        elif fuse_view_feats == "sum_proj":
            self.fuse_view_projection = Dense(d_model, d_model, dtype,
                                              generator=g)
        elif fuse_view_feats == "attn_fuse_subtract":
            self.attn_proj = Dense(d_model, 1, dtype, generator=g)
        self.norm1 = LayerNorm(d_model, dtype)
        self.linear1 = Dense(d_model, d_ffn, dtype, generator=g)
        self.linear2 = Dense(d_ffn, d_model, dtype, generator=g)
        self.norm3 = LayerNorm(d_model, dtype)

    def forward(self, tgt: torch.Tensor, query_pos: torch.Tensor,
                reference_points_norm: torch.Tensor,
                src_views: Sequence[torch.Tensor], spatial_shapes,
                view_data: ViewData,
                camera_ray_embeds: Optional[torch.Tensor] = None,
                train: bool = False,
                dropout_seed: Optional[int] = None, grid=None
                ) -> torch.Tensor:
        """tgt / query_pos (B, Nq, C); reference_points_norm (B, Nq, 3) in
        the normalized [0, 1] capture space; src_views per-level
        (V*B, h, w, C) view-major; camera_ray_embeds (V*B, sum hw, 3 or 2)
        where the posembed mode takes them. Under a view split (`grid`)
        view_data, src_views and the rays hold this rank's views. Returns
        (B, Nq, C)."""
        B, Nq, C = tgt.shape
        n = collectives.axis_size(grid)
        V = view_data.num_views  # this rank's views
        if V * n != self.n_views and self.fuse_view_feats == "cat_proj":
            raise ValueError(f"cat_proj fuses DATASET.CAMERA_NUM = "
                             f"{self.n_views} views, the batch has {V * n}")
        img_wh = torch.tensor(self.img_size, dtype=torch.float32,
                              device=tgt.device)
        drop = _drop_fn(self.dropout, dropout_seed if train
                        and self.dropout > 0.0 else None, tgt.device)

        # self-attention over the queries
        q = tgt + query_pos
        tgt = self.norm2(tgt + drop(self.self_attn(q, q, tgt)))

        # project the normalized refs into every view
        refs = reference_points_norm
        if self.detach_refpoints:
            refs = refs.detach()
        refs_abs = norm2absolute(refs.float(), self.space_size,
                                 self.space_center)
        pix = project_points(refs_abs[:, None].expand(B, V, Nq, 3),
                             view_data.cameras)
        wh = view_data.centers * 2.0
        bounds = ((pix[..., 0] >= 0) & (pix[..., 1] >= 0)
                  & (pix[..., 0] < wh[..., 0:1])
                  & (pix[..., 1] < wh[..., 1:2]))  # (B, V, Nq)
        # one scalar clip for every view: the largest width or height
        pix = torch.minimum(torch.clamp(pix, min=-1.0), wh.max())
        norm = apply_affine(pix, view_data.affine) / img_wh
        whl = torch.tensor([[w, h] for h, w in spatial_shapes],
                           dtype=torch.float32, device=tgt.device)
        ref_lvl = norm[..., None, :] * (whl / (whl - 1.0))

        # projective attention over every view at once
        q_fold = (tgt + query_pos)[None].expand(V, B, Nq, C).reshape(
            V * B, Nq, C)
        ref_fold = ref_lvl.transpose(0, 1).reshape(V * B, Nq,
                                                   len(spatial_shapes), 2)
        tgt2, _ = self.proj_attn(q_fold, ref_fold, src_views, spatial_shapes,
                                 train=train,
                                 camera_ray_embeds=camera_ray_embeds)
        tgt2 = tgt2.reshape(V, B, Nq, C) * bounds.transpose(
            0, 1)[..., None].to(tgt2.dtype)

        # fuse the views
        mode = self.fuse_view_feats
        if mode == "mean":
            fused = collectives.view_mean(tgt2, grid)
        elif mode == "cat_proj" and n > 1:
            fused = self.split_cat_proj(tgt2, grid)
        elif mode == "cat_proj":
            fused = self.fuse_view_projection(
                tgt2.permute(1, 2, 0, 3).reshape(B, Nq, V * C))
        elif mode == "sum_proj":
            fused = self.fuse_view_projection(
                collectives.view_sum(tgt2, grid))
        elif mode == "attn_fuse_dot_prod":
            logits = torch.einsum("vbnc,bnc->vbn", tgt2.float(), tgt.float())
            logits = collectives.all_gather(logits, grid, dim=0)
            aw = torch.softmax(logits, dim=0)[..., None]
            if n > 1:
                aw = aw[grid.view_slice(aw.shape[0])]
            fused = collectives.view_sum(tgt2 * aw.to(tgt2.dtype), grid)
        else:  # attn_fuse_subtract
            aw = self.attn_proj(tgt2 - tgt[None])
            fused = collectives.view_sum(tgt2 * aw, grid)
        tgt = self.norm1(tgt + drop(fused))

        # FFN
        x = self.linear2(drop(F.relu(self.linear1(tgt))))
        return self.norm3(tgt + drop(x))

    def split_cat_proj(self, tgt2: torch.Tensor, grid) -> torch.Tensor:
        """'cat_proj' under a view split: this rank's views (V_local, B,
        Nq, C) times their columns of `fuse_view_projection`'s weight, the
        partial products summed over the view group in float32, then the
        bias, in the layer's dtype."""
        proj = self.fuse_view_projection
        Vl, B, Nq, C = tgt2.shape
        cols = grid.view_slice(self.n_views)
        w = proj.weight[:, cols.start * C:cols.stop * C]
        part = F.linear(tgt2.permute(1, 2, 0, 3).reshape(B, Nq, Vl * C)
                        .to(proj.dtype), w.to(proj.dtype))
        total = collectives.all_reduce_sum(part.float(), grid)
        return (total + proj.bias.float()).to(proj.dtype)


class MvPDecoder(nn.Module):
    """The stack of MvP decoder layers (`layers.{i}`)."""

    def __init__(self, num_layers: int, **layer_kwargs):
        super().__init__()
        self.layers = nn.ModuleList(MvPDecoderLayer(**layer_kwargs)
                                    for _ in range(num_layers))


def camera_embeddings(mode: str, view_data: ViewData, spatial_shapes,
                      image_size) -> Optional[torch.Tensor]:
    """The per-pixel embeddings of ProjAttn's posembed mode for every
    level, view-major (V*B, sum hw, 3 or 2) float32: unit camera rays in
    world coordinates ('use_rayconv') or normalized 2D coordinates
    ('use_2d_coordconv'); None for 'ablation_not_use_rayconv'."""
    B, V = view_data.affine.shape[:2]
    levels = []
    if mode == "use_rayconv":
        cams = view_data.cameras
        Kc = crop_intrinsics(calib_matrix(cams), view_data.affine)
        # t with x_cam = R x + t
        T_standard = -(cams.R.float() @ cams.T.float())
        for h, w in spatial_shapes:
            r = get_rays(tuple(image_size), h, w, Kc, cams.R, T_standard)
            levels.append(r.transpose(0, 1).reshape(V * B, h * w, 3))
    elif mode == "use_2d_coordconv":
        for h, w in spatial_shapes:
            c2 = get_2d_coords(h, w, device=view_data.affine.device)
            levels.append(c2.reshape(1, h * w, 2).expand(V * B, -1, -1))
    else:
        return None
    return torch.cat(levels, dim=1)


class MvPTransformer(nn.Module):
    """The MvP baseline top model. Call with a Batch; returns per decoder
    layer {pred_logits (B, Q, 2), pred_poses (B, Q*J, 3) mm}.

    The weights are drawn on the CPU from `generator` and then moved to
    `device`, the card unless the caller asks for the CPU."""

    def __init__(self, cfg: Config,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        dec = cfg.DECODER
        self.dtype = compute_dtype(cfg)
        self.num_joints = dec.num_keypoints
        self.num_instance = dec.num_instance
        g = generator
        self.backbone = PoseResNet(cfg.POSE_RESNET.NUM_LAYERS,
                                   tuple(cfg.POSE_RESNET.NUM_DECONV_FILTERS),
                                   dtype=self.dtype, generator=g)
        self.joint_embedding = nn.Embedding(dec.num_keypoints,
                                            dec.d_model * 2)
        self.instance_embedding = nn.Embedding(dec.num_instance,
                                               dec.d_model * 2)
        with torch.no_grad():
            for emb in (self.joint_embedding, self.instance_embedding):
                nn.init.normal_(emb.weight, 0.0, 1.0, generator=g)
        self.decoder = MvPDecoder(
            dec.num_decoder_layers, d_model=dec.d_model,
            d_ffn=dec.dim_feedforward, dropout=dec.dropout,
            n_levels=dec.num_feature_levels, n_heads=dec.nhead,
            n_points=dec.dec_n_points,
            img_size=tuple(cfg.NETWORK.IMAGE_SIZE),
            space_size=tuple(cfg.MULTI_PERSON.SPACE_SIZE),
            space_center=tuple(cfg.MULTI_PERSON.SPACE_CENTER),
            detach_refpoints=dec.detach_refpoints_cameraprj_firstlayer,
            fuse_view_feats=dec.fuse_view_feats,
            n_views=cfg.DATASET.CAMERA_NUM,
            posembed_mode=dec.projattn_posembed_mode, dtype=self.dtype,
            generator=g)
        self.class_embed = nn.ModuleList(
            Dense(dec.d_model, 2, self.dtype, generator=g)
            for _ in range(dec.num_decoder_layers))
        self.pose_embed = nn.ModuleList(
            MLP(dec.d_model, dec.d_model, 3, dec.pose_embed_layer,
                self.dtype, generator=g)
            for _ in range(dec.num_decoder_layers))
        # the query-adaptation heads, float32; the input width of
        # reference_feats is fixed here (flax infers it at init)
        if dec.query_adaptation:
            n_levels = len(feature_spatial_shapes(cfg))
            self.reference_feats = Dense(
                cfg.DATASET.CAMERA_NUM * n_levels * dec.d_model,
                dec.d_model, generator=g)
        self.reference_points = Dense(dec.d_model, 3, generator=g)
        self.to(device)

    def forward(self, batch: Batch, train: bool = False,
                generator: Optional[torch.Generator] = None, grid=None):
        """train: the training forward (dropout drawn from `generator`,
        the corner-table sampler); the backbone takes no gradient unless
        TRAIN.TRAIN_BACKBONE. grid: the (data x view) grid
        (`parallel.DataParallel`), None in one process; under a view
        split the batch holds this rank's views."""
        cfg, dec = self.cfg, self.cfg.DECODER
        B, V = batch.views.shape[:2]
        imgs = batch.views.transpose(0, 1).reshape(
            (V * B,) + tuple(batch.views.shape[2:]))
        with span("mvg.backbone"), torch.set_grad_enabled(
                torch.is_grad_enabled() and cfg.TRAIN.TRAIN_BACKBONE):
            feats = self.backbone(imgs, use_feat_level=tuple(
                dec.use_feat_level))[::-1]
        spatial_shapes = tuple((int(f.shape[1]), int(f.shape[2]))
                               for f in feats)
        with span("mvg.init"):
            rays = camera_embeddings(dec.projattn_posembed_mode,
                                     batch.view_data, spatial_shapes,
                                     cfg.NETWORK.IMAGE_SIZE)
            query_embeds = (self.joint_embedding.weight[None]
                            + self.instance_embedding.weight[:, None]
                            ).reshape(self.num_instance * self.num_joints,
                                      -1)
            c = dec.d_model
            query_pos = query_embeds[None, :, :c].expand(B, -1, -1)
            tgt = query_embeds[None, :, c:].expand(B, -1, -1)
            base = query_pos.float()
            if dec.query_adaptation:
                base = base + pooled_view_features(
                    feats, B, self.reference_feats, grid)
            reference = torch.sigmoid(self.reference_points(base))
            out = tgt.to(self.dtype)
            query_pos = query_pos.to(self.dtype)

        layers = self.decoder.layers
        seeds = [None] * len(layers)
        if train and dec.dropout > 0.0:
            seeds = host_seeds(generator, len(layers))
        outs = []
        for lid, layer in enumerate(layers):
            with span(LAYER.format(lid)):
                out = layer(out, query_pos, reference, feats,
                            spatial_shapes, batch.view_data,
                            camera_ray_embeds=rays, train=train,
                            dropout_seed=seeds[lid], grid=grid)
                # iterative refinement in inverse-sigmoid space
                delta = self.pose_embed[lid](out).float()
                reference_new = torch.sigmoid(delta
                                              + inverse_sigmoid(reference))
                prob = torch.sigmoid(self.class_embed[lid](out).float())
                class_prob = prob.reshape(B, self.num_instance,
                                          self.num_joints, 2).mean(dim=2)
                outs.append({
                    "pred_logits": inverse_sigmoid(class_prob),
                    "pred_poses": norm2absolute(
                        reference_new, cfg.MULTI_PERSON.SPACE_SIZE,
                        cfg.MULTI_PERSON.SPACE_CENTER)})
                reference = (reference_new.detach()
                             if dec.detach_refpoints_cameraprj_firstlayer
                             else reference_new)
        return outs
