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
    pred_poses_2d, pred_poses_2d_proj}.

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
from mvgformer_tpu_torch.data.meta import Batch
from mvgformer_tpu_torch.data.synthetic import T_POSE
from mvgformer_tpu_torch.device import compute_dtype
from mvgformer_tpu_torch.models.decoder import DQDecoder
from mvgformer_tpu_torch.models.pose_resnet import PoseResNet

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
        "DECODER.clamp_refs_to_space": (dec.clamp_refs_to_space, False),
        "DECODER.convert_joint_format_indices": (
            dec.convert_joint_format_indices, None),
        "DECODER.layer1_windowed_sampling": (dec.layer1_windowed_sampling,
                                             False),
        "DECODER.layer1_offset_clamp": (dec.layer1_offset_clamp, None),
    }
    bad = [f"{k}={got!r}" for k, (got, want) in wanted.items()
           if got != want]
    if dec.triangulation_method == "st":
        bad.append("DECODER.triangulation_method='st'")
    if bad:
        raise NotImplementedError("not ported yet: " + ", ".join(bad))


class MVGFormer(nn.Module):
    """Full model. Call with a Batch; returns per-layer output dicts."""

    def __init__(self, cfg: Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_supported(cfg)
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
        with torch.no_grad():
            for emb in (self.joint_embedding, self.instance_embedding):
                nn.init.normal_(emb.weight, 0.0, 1.0, generator=generator)
        self.decoder = DQDecoder(
            num_layers=dec.num_decoder_layers,
            num_joints=dec.num_keypoints,
            d_model=dec.d_model,
            d_ffn=dec.dim_feedforward,
            n_levels=dec.num_feature_levels,
            n_heads=dec.nhead,
            n_points=dec.dec_n_points,
            img_size=tuple(cfg.NETWORK.IMAGE_SIZE),
            open_forward_ffn=dec.open_forward_ffn,
            # 'linalg'/'batch'/'default' are the reference's SVD variants
            triangulation_solver=(dec.triangulation_method
                                  if dec.triangulation_method in
                                  ("eigh", "jacobi") else "svd"),
            pose_embed_layers=dec.pose_embed_layer,
            dtype=self.dtype,
            generator=generator)
        self.register_buffer(
            "init_reference", torch.from_numpy(sample_space_reference_points(
                dec.num_instance, load_tpose(dec.t_pose_dir),
                cfg.MULTI_PERSON.SPACE_SIZE,
                cfg.MULTI_PERSON.SPACE_CENTER)), persistent=False)

    def forward(self, batch: Batch, threshold: float = 0.5):
        """Per decoder layer, a dict of
            pred_logits:        (B, Q, 2) inverse-sigmoid of avg joint prob
            pred_poses:         (B, Q*J, 3) absolute mm
            pred_poses_2d:      (B, V, Q*J, 2) refined 2D (net image, px)
            pred_poses_2d_proj: (B, V, Q*J, 2) projected 2D (net image, px)
        """
        dec = self.cfg.DECODER
        B, V = batch.views.shape[:2]

        # backbone on the view-major fold, levels finest-first
        imgs = batch.views.transpose(0, 1).reshape(
            (V * B,) + tuple(batch.views.shape[2:]))
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
            point_topm=dec.inference_point_topm)
        return [{"pred_logits": inverse_sigmoid(lo["class_prob"]),
                 "pred_poses": lo["refs"],
                 "pred_poses_2d": lo["refs_2d"],
                 "pred_poses_2d_proj": lo["projs_2d"]}
                for lo in layer_outputs]
