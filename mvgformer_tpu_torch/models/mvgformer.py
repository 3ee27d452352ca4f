"""MVGFormer top model: backbone -> queries -> iterative-geometry decoder.

Port of `mvgformer_tpu/models/mvgformer.py` for the 'sample_space'
reference init:

  * PoseResNet features for all (batch, view) images in one view-major
    folded pass, levels reversed to finest-first;
  * person_joint query embeddings (joint-embed + instance-embed outer sum),
    the first d_model channels positional, the rest content;
  * reference points on a ceil(sqrt(Q))^2 grid over (x, y) at z = 0.5 of
    the normalized space, plus T-pose offsets;
  * the DQ decoder; per-layer outputs {pred_logits, pred_poses,
    pred_poses_2d, pred_poses_2d_proj}, their joints reordered by
    DECODER.convert_joint_format_indices where set (Panoptic's 15 joints
    to Shelf / Campus's 14);
  * DECODER.clamp_refs_to_space: each layer's next-layer reference points
    clipped to the capture space, centre +- 0.75 x size (the outputs keep
    the raw predictions);
  * the windowed layer-1 serving path (DECODER.layer1_windowed_sampling):
    `build_layer1_window_plan` buckets the static layer-1 centers once per
    rig, and `forward(..., window_plan=plan)` samples layer 1 through the
    window kernels.

Parameter names follow the original torch model, so
`mvgformer_tpu.utils.torch_convert.convert_mvgformer_state_dict` reads this
module's state_dict as it reads a released checkpoint.
"""

from __future__ import annotations

import math
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch import nn

from mvgformer_tpu_torch.config import Config
from mvgformer_tpu_torch.data.meta import Batch, ViewData, map_tensors
from mvgformer_tpu_torch.data.synthetic import T_POSE
from mvgformer_tpu_torch.device import compute_dtype, resolve_device
from mvgformer_tpu_torch.models.decoder import (DQDecoder,
                                                project_reference_points)
from mvgformer_tpu_torch.models.pose_resnet import PoseResNet
from mvgformer_tpu_torch.ops.window_sampling import (WindowPlan,
                                                     build_window_plan)

# the T-pose asset is shared with the JAX package
_TPOSE_ASSET = (Path(__file__).resolve().parents[2] / "mvgformer_tpu"
                / "assets" / "tpose.npy")


def load_tpose(path: Optional[str] = None) -> np.ndarray:
    """(15, 3) root-relative T-pose offsets in mm: `path` if it exists, else
    the bundled asset if present, else the built-in T_POSE."""
    for cand in ([path] if path else []) + [str(_TPOSE_ASSET)]:
        if os.path.isfile(cand):
            if cand.endswith(".pt"):
                return torch.load(cand, map_location="cpu",
                                  weights_only=False).numpy().astype(
                    np.float32)
            return np.load(cand).astype(np.float32)
    return T_POSE


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = torch.clamp(x, 0.0, 1.0)
    return torch.log(torch.clamp(x, min=eps) / torch.clamp(1.0 - x, min=eps))


def sample_space_reference_points(num_instance: int, t_pose: np.ndarray,
                                  space_size, space_center) -> np.ndarray:
    """'sample_space' init: a ceil(sqrt(Q))^2 grid over normalized (x, y)
    (meshgrid 'ij'), z = 0.5, mapped to mm, plus T-pose offsets.
    Returns (Q * J, 3) float32."""
    n = math.ceil(num_instance ** 0.5)
    lin = np.linspace(0.0, 1.0, n, dtype=np.float32)
    gx, gy = np.meshgrid(lin, lin, indexing="ij")
    roots_norm = np.stack(
        [gx.reshape(-1), gy.reshape(-1),
         np.full(n * n, 0.5, dtype=np.float32)], axis=-1)[:num_instance]
    gs = np.asarray(space_size, dtype=np.float32)
    gc = np.asarray(space_center, dtype=np.float32)
    roots_abs = roots_norm * gs + gc - gs / 2.0
    joints = roots_abs[:, None, :] + t_pose[None, :, :]
    return joints.reshape(-1, 3).astype(np.float32)


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for config values this port does not run
    yet (ROADMAP.md lists them)."""
    dec = cfg.DECODER
    wanted = {
        "TRANSFORMER": (cfg.TRANSFORMER, "dq_transformer"),
        "DECODER.init_ref_method": (dec.init_ref_method, "sample_space"),
        "DECODER.feature_update_method": (dec.feature_update_method, "MLP"),
        "DECODER.projattn_posembed_mode": (dec.projattn_posembed_mode,
                                           "ablation_not_use_rayconv"),
        "DECODER.init_self_attention": (dec.init_self_attention, False),
        "DECODER.bayesian_update": (dec.bayesian_update, False),
        "DECODER.share_layer_weights": (dec.share_layer_weights, False),
    }
    bad = [f"{k}={got!r}" for k, (got, want) in wanted.items()
           if got != want]
    if dec.triangulation_method == "st":
        bad.append("DECODER.triangulation_method='st'")
    # training knobs
    if cfg.TRAIN.SAMPLE_CHUNKS is not None and cfg.TRAIN.SAMPLE_CHUNKS > 1:
        bad.append(f"TRAIN.SAMPLE_CHUNKS={cfg.TRAIN.SAMPLE_CHUNKS!r}")
    if cfg.PARALLEL.REMAT_DECODER and cfg.PARALLEL.REMAT_POLICY != "full":
        bad.append(f"PARALLEL.REMAT_POLICY={cfg.PARALLEL.REMAT_POLICY!r}")
    if bad:
        raise NotImplementedError("not ported yet: " + ", ".join(bad))


class MVGFormer(nn.Module):
    """Full model. Call with a Batch; returns per-layer output dicts.

    The weights are drawn on the CPU from `generator` (a CPU generator) and
    then moved to `device`, so a seed gives the same weights on either
    device. `device` defaults to the card and raises without one."""

    def __init__(self, cfg: Config,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        dec = cfg.DECODER
        self.dtype = compute_dtype(cfg)
        self.num_joints = dec.num_keypoints
        self.num_instance = dec.num_instance
        self.backbone = PoseResNet(cfg.POSE_RESNET.NUM_LAYERS,
                                   tuple(cfg.POSE_RESNET.NUM_DECONV_FILTERS),
                                   dtype=self.dtype, generator=generator)
        self.joint_embedding = nn.Embedding(dec.num_keypoints,
                                            dec.d_model * 2)
        self.instance_embedding = nn.Embedding(dec.num_instance,
                                               dec.d_model * 2)
        ref_clamp_box = None
        if dec.clamp_refs_to_space:
            # the capture space with 50% slack on the half-extent
            c = cfg.MULTI_PERSON.SPACE_CENTER
            s = cfg.MULTI_PERSON.SPACE_SIZE
            ref_clamp_box = (tuple(c[i] - 0.75 * s[i] for i in range(3))
                             + tuple(c[i] + 0.75 * s[i] for i in range(3)))
        with torch.no_grad():
            for emb in (self.joint_embedding, self.instance_embedding):
                nn.init.normal_(emb.weight, 0.0, 1.0, generator=generator)
        self.decoder = DQDecoder(
            num_layers=dec.num_decoder_layers,
            num_joints=dec.num_keypoints,
            remat=cfg.PARALLEL.REMAT_DECODER,
            ref_clamp_box=ref_clamp_box,
            d_model=dec.d_model,
            d_ffn=dec.dim_feedforward,
            dropout=dec.dropout,
            n_levels=dec.num_feature_levels,
            n_heads=dec.nhead,
            n_points=dec.dec_n_points,
            img_size=tuple(cfg.NETWORK.IMAGE_SIZE),
            detach_refpoints=dec.detach_refpoints_cameraprj_firstlayer,
            open_forward_ffn=dec.open_forward_ffn,
            # 'linalg'/'batch'/'default' are the reference's SVD variants
            triangulation_solver=(dec.triangulation_method
                                  if dec.triangulation_method in
                                  ("eigh", "jacobi") else "svd"),
            pose_embed_layers=dec.pose_embed_layer,
            tri_grad_clip=cfg.TRAIN.TRI_GRAD_CLIP,
            dtype=self.dtype,
            generator=generator)
        self.register_buffer(
            "init_reference", torch.from_numpy(sample_space_reference_points(
                dec.num_instance, load_tpose(dec.t_pose_dir),
                cfg.MULTI_PERSON.SPACE_SIZE,
                cfg.MULTI_PERSON.SPACE_CENTER)), persistent=False)
        self.to(device)

    def initial_reference_points_static(self, batch_size: int
                                        ) -> torch.Tensor:
        """(B, Q*J, 3) absolute-mm initial query poses: the config's
        sample_space grid, no parameters involved."""
        return self.init_reference[None].expand(batch_size, -1, -1)

    def forward(self, batch: Batch, query_mask: Optional[torch.Tensor] = None,
                threshold: float = 0.5, train: bool = False,
                window_plan: Optional[WindowPlan] = None,
                generator: Optional[torch.Generator] = None):
        """Per decoder layer, a dict of
            pred_logits:        (B, Q, 2) inverse-sigmoid of avg joint prob
            pred_poses:         (B, Q*J, 3) absolute mm
            pred_poses_2d:      (B, V, Q*J, 2) refined 2D (net image, px)
            pred_poses_2d_proj: (B, V, Q*J, 2) projected 2D (net image, px)
        With a window_plan (`build_layer1_window_plan`), layer 1 samples
        through the window kernels and its dict also holds
            escaped_mass:       float32 scalar, the attention mass of
                                samples that escaped their window.
        train: the training forward (dropout drawn from `generator`, the
        corner-table sampler, the (B, Q) gt-match `query_mask`); the window
        plan, top-K and point-top-m are off then. The backbone takes no
        gradient unless TRAIN.TRAIN_BACKBONE.
        """
        dec = self.cfg.DECODER
        if window_plan is not None and dec.init_ref_method != "sample_space":
            raise ValueError(
                "windowed layer-1 sampling requires the rig-static "
                "'sample_space' reference init (got %r)"
                % dec.init_ref_method)
        B, V = batch.views.shape[:2]

        # backbone on the view-major fold, levels finest-first; frozen
        # unless TRAIN.TRAIN_BACKBONE (JAX's stop_gradient)
        imgs = batch.views.transpose(0, 1).reshape(
            (V * B,) + tuple(batch.views.shape[2:]))
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and self.cfg.TRAIN.TRAIN_BACKBONE):
            feats = self.backbone(imgs, use_feat_level=tuple(
                dec.use_feat_level))[::-1]
        spatial_shapes = tuple((int(f.shape[1]), int(f.shape[2]))
                               for f in feats)

        query_embeds = (self.joint_embedding.weight[None]
                        + self.instance_embedding.weight[:, None]).reshape(
            self.num_instance * self.num_joints, -1)
        c = dec.d_model
        query_pos = None
        if not dec.close_pose_embedding:
            query_pos = query_embeds[None, :, :c].expand(
                B, -1, -1).to(self.dtype)
        tgt = query_embeds[None, :, c:].expand(B, -1, -1).to(self.dtype)
        refs0 = self.init_reference[None].expand(B, -1, -1)

        layer_outputs = self.decoder(
            tgt, query_pos, refs0, feats, spatial_shapes, batch.view_data,
            threshold=threshold,
            filter_method=(dec.query_filter_method if dec.filter_query
                           else "all"),
            topk_queries=dec.inference_topk_queries,
            window_plan=window_plan,
            layer1_offset_clamp=dec.layer1_offset_clamp,
            point_topm=dec.inference_point_topm,
            query_mask=query_mask, train=train, generator=generator)
        cji = dec.convert_joint_format_indices
        J = self.num_joints
        outs = []
        for lo in layer_outputs:
            coords, coords_2d = lo["refs"], lo["refs_2d"]
            coords_2d_proj = lo["projs_2d"]
            if cji is not None:
                idx = list(cji)
                coords = coords.reshape(B, -1, J, 3)[:, :, idx].reshape(
                    B, -1, 3)
                coords_2d = coords_2d.reshape(B, V, -1, J, 2)[
                    :, :, :, idx].reshape(B, V, -1, 2)
                coords_2d_proj = coords_2d_proj.reshape(B, V, -1, J, 2)[
                    :, :, :, idx].reshape(B, V, -1, 2)
            outs.append({"pred_logits": inverse_sigmoid(lo["class_prob"]),
                         "pred_poses": coords,
                         "pred_poses_2d": coords_2d,
                         "pred_poses_2d_proj": coords_2d_proj})
            if "escaped_mass" in lo:
                outs[-1]["escaped_mass"] = lo["escaped_mass"]
        return outs


def feature_spatial_shapes(cfg: Config):
    """Static (h, w) of each selected backbone level, finest-first: the
    backbone's levels come out at strides 16, 8, 4 (filtered by membership
    in DECODER.use_feat_level) and are reversed."""
    W, H = cfg.NETWORK.IMAGE_SIZE
    strides = [16, 8, 4]
    sel = [s for i, s in enumerate(strides)
           if i in tuple(cfg.DECODER.use_feat_level)][::-1]
    return tuple((H // s, W // s) for s in sel)


def layer1_centers_px(cfg: Config, view_data: ViewData) -> np.ndarray:
    """(V, Q*J, L, 2) static layer-1 sampling centers, in each level's
    pixels (loc * size - 0.5): the sample_space grid projected through the
    rig of the first batch item."""
    dec = cfg.DECODER
    shapes = feature_spatial_shapes(cfg)
    refs = sample_space_reference_points(
        dec.num_instance, load_tpose(dec.t_pose_dir),
        cfg.MULTI_PERSON.SPACE_SIZE, cfg.MULTI_PERSON.SPACE_CENTER)
    vd0 = map_tensors(view_data, lambda t: t[:1].cpu())
    with torch.no_grad():
        _, lvl, _ = project_reference_points(
            torch.from_numpy(refs)[None], vd0, shapes,
            cfg.NETWORK.IMAGE_SIZE)
    lvl = lvl[0].numpy()  # (V, Nq, L, 2) normalized per level
    centers_px = np.empty_like(lvl)
    for li, (h, w) in enumerate(shapes):
        centers_px[:, :, li, 0] = lvl[:, :, li, 0] * w - 0.5
        centers_px[:, :, li, 1] = lvl[:, :, li, 1] * h - 0.5
    return centers_px


def layer1_window_plan_host(cfg: Config, view_data: ViewData,
                            tile: Optional[int] = None,
                            halo: Optional[int] = None) -> WindowPlan:
    """Host-side, once per rig: bucket the static layer-1 sampling centers
    into feature-map tiles for the windowed sampler; the plan's arrays are
    numpy, equal to JAX's. Only the first batch item of view_data is read
    (a rig is batch-constant). halo defaults to dec_n_points + 2, which
    makes the windowed op exact at offset init (radial bias <= n_points
    px), or to ceil(clamp) + 2 under DECODER.layer1_offset_clamp."""
    dec = cfg.DECODER
    if tile is None:
        tile = dec.layer1_window_tile
    if halo is None:
        halo = dec.layer1_window_halo
    if halo is None:
        if dec.layer1_offset_clamp is not None:
            # clamped offsets: the window is exact once it covers
            # clamp + 2 px (bilinear stencil + border) past the tile
            halo = int(np.ceil(dec.layer1_offset_clamp)) + 2
        else:
            halo = dec.dec_n_points + 2
    if (dec.layer1_offset_clamp is not None
            and dec.layer1_offset_clamp > halo - 2):
        raise ValueError(
            "layer1_offset_clamp=%g exceeds halo-2=%d: escaped samples "
            "would read zero; raise layer1_window_halo"
            % (dec.layer1_offset_clamp, halo - 2))
    return build_window_plan(layer1_centers_px(cfg, view_data),
                             feature_spatial_shapes(cfg), tile=tile,
                             halo=halo, impl=dec.layer1_window_impl)


def build_layer1_window_plan(cfg: Config, view_data: ViewData,
                             tile: Optional[int] = None,
                             halo: Optional[int] = None,
                             device="cuda") -> WindowPlan:
    """The layer-1 window plan of the rig (`layer1_window_plan_host`) with
    its arrays as tensors on `device`: the card unless the caller asks for
    the CPU (raises without a card). Build it once per rig and pass it to
    every frame."""
    device = resolve_device(device)
    return layer1_window_plan_host(cfg, view_data, tile, halo).to(device)
