"""Load the original torch repo's MVGFormer checkpoints (`.pth.tar`).

The port's counterpart of `mvgformer_tpu/utils/torch_convert.py`. The port
keeps the original parameter names, so converting is a filter: strip the
'module.' prefix of a DDP checkpoint and keep, as float32, what the port's
modules hold. Parameters with no live role in the forward are dropped: the
top-level cloned pose_embed / class_embed lists, reference_points,
level_embed, the unused per-layer self_attn and the PoseResNet's
final_layer. BatchNorm's num_batches_tracked is set to 0, as carrying the
weights through the JAX package's variables gives (the model reads only
the running statistics).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from mvgformer_tpu_torch.config import Config

_BN = ("weight", "bias", "running_mean", "running_var")


def _float(v) -> torch.Tensor:
    return torch.as_tensor(v).detach().to("cpu", torch.float32).clone()


def convert_mvgformer_state_dict(state_dict: Mapping, cfg: Config
                                 ) -> Dict[str, torch.Tensor]:
    """An original-repo state_dict -> this package's MVGFormer
    state_dict."""
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in state_dict.items()}
    out: Dict[str, torch.Tensor] = {}

    def take(name):
        out[name] = _float(sd[name])

    def bn(name):
        for p in _BN:
            take(f"{name}.{p}")
        out[f"{name}.num_batches_tracked"] = torch.tensor(0,
                                                          dtype=torch.long)

    def linear(name):
        take(f"{name}.weight")
        take(f"{name}.bias")

    take("backbone.conv1.weight")
    bn("backbone.bn1")
    li = 1
    while f"backbone.layer{li}.0.conv1.weight" in sd:
        bi = 0
        while f"backbone.layer{li}.{bi}.conv1.weight" in sd:
            block = f"backbone.layer{li}.{bi}"
            for k in (1, 2, 3):
                take(f"{block}.conv{k}.weight")
                bn(f"{block}.bn{k}")
            if f"{block}.downsample.0.weight" in sd:
                take(f"{block}.downsample.0.weight")
                bn(f"{block}.downsample.1")
            bi += 1
        li += 1
    for di in range(len(cfg.POSE_RESNET.NUM_DECONV_FILTERS)):
        take(f"backbone.deconv_layers.{3 * di}.weight")
        bn(f"backbone.deconv_layers.{3 * di + 1}")

    take("joint_embedding.weight")
    take("instance_embedding.weight")
    dec = cfg.DECODER
    for i in range(dec.num_decoder_layers):
        layer = f"decoder.layers.{i}"
        for lin in ("sampling_offsets", "attention_weights", "rayconv",
                    "output_proj"):
            linear(f"{layer}.proj_attn.{lin}")
        linear(f"{layer}.feature_update_mlp")
        linear(f"{layer}.norm2")
        if dec.open_forward_ffn:
            linear(f"{layer}.linear1")
            linear(f"{layer}.linear2")
            linear(f"{layer}.norm3")
        linear(f"{layer}.class_embed")
        for j in range(dec.pose_embed_layer):
            linear(f"{layer}.pose_embed.MLP.layers.{j}")
    return out


def load_torch_checkpoint(path: str, cfg: Config) -> Dict[str, torch.Tensor]:
    """Load an original-repo `.pth.tar` file and convert it. These files
    are the original repo's pickles, hence weights_only=False here (and
    only here)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return convert_mvgformer_state_dict(sd, cfg)
