"""Carry MVGFormer weights from the JAX package's flax variables to this
package's state_dict.

The inverse of `mvgformer_tpu/utils/torch_convert.py`: the flax
{'params', 'batch_stats'} tree, with numpy leaves, becomes a state_dict
named like the original torch model, which `MVGFormer.load_state_dict`
takes and `convert_mvgformer_state_dict` turns back into the same tree.

Layouts:
    Dense kernel (in, out)                    -> Linear weight (out, in)
    Conv kernel HWIO                          -> Conv2d weight OIHW
    ConvTranspose kernel (kh, kw, out, in)    -> ConvTranspose2d (in, out,
                                                 kh, kw)
    BatchNorm scale/bias + batch_stats mean/var
                                              -> weight/bias/running_mean/
                                                 running_var
    LayerNorm scale/bias                      -> weight/bias
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from mvgformer_tpu_torch.config import Config
from mvgformer_tpu_torch.models.pose_resnet import RESNET_BLOCKS


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(sd, node, name):
    sd[name + ".weight"] = _t(np.asarray(node["kernel"]).T)
    sd[name + ".bias"] = _t(node["bias"])


def _layernorm(sd, node, name):
    sd[name + ".weight"] = _t(node["scale"])
    sd[name + ".bias"] = _t(node["bias"])


def _conv(sd, node, name):
    # HWIO and the transposed (kh, kw, out, in) both map by (3, 2, 0, 1)
    sd[name + ".weight"] = _t(np.transpose(np.asarray(node["kernel"]),
                                           (3, 2, 0, 1)))


def _bn(sd, params, stats, name):
    sd[name + ".weight"] = _t(params["scale"])
    sd[name + ".bias"] = _t(params["bias"])
    sd[name + ".running_mean"] = _t(stats["mean"])
    sd[name + ".running_var"] = _t(stats["var"])
    sd[name + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def port_state_dict_from_jax(variables: Mapping,
                             cfg: Config) -> Dict[str, torch.Tensor]:
    """flax variables {'params', 'batch_stats'} -> MVGFormer state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    bp, bs = params["backbone"], stats["backbone"]
    _conv(sd, bp["conv1"], "backbone.conv1")
    _bn(sd, bp["bn1"], bs["bn1"], "backbone.bn1")
    for li, n_blocks in enumerate(RESNET_BLOCKS[cfg.POSE_RESNET.NUM_LAYERS]):
        for bi in range(n_blocks):
            src = f"layer{li + 1}_{bi}"
            dst = f"backbone.layer{li + 1}.{bi}"
            for k in (1, 2, 3):
                _conv(sd, bp[src][f"conv{k}"], f"{dst}.conv{k}")
                _bn(sd, bp[src][f"bn{k}"], bs[src][f"bn{k}"], f"{dst}.bn{k}")
            if "downsample_conv" in bp[src]:
                _conv(sd, bp[src]["downsample_conv"], f"{dst}.downsample.0")
                _bn(sd, bp[src]["downsample_bn"], bs[src]["downsample_bn"],
                    f"{dst}.downsample.1")
    for di in range(len(cfg.POSE_RESNET.NUM_DECONV_FILTERS)):
        _conv(sd, bp[f"deconv{di}"], f"backbone.deconv_layers.{3 * di}")
        _bn(sd, bp[f"deconv_bn{di}"], bs[f"deconv_bn{di}"],
            f"backbone.deconv_layers.{3 * di + 1}")

    sd["joint_embedding.weight"] = _t(params["joint_embedding"])
    sd["instance_embedding.weight"] = _t(params["instance_embedding"])

    dec = cfg.DECODER
    for i in range(dec.num_decoder_layers):
        lp = params["decoder"][f"layer_{i}"]
        dst = f"decoder.layers.{i}"
        for lin in ("sampling_offsets", "attention_weights", "rayconv",
                    "output_proj"):
            _dense(sd, lp["proj_attn"][lin], f"{dst}.proj_attn.{lin}")
        _dense(sd, lp["feature_update_mlp"], f"{dst}.feature_update_mlp")
        _layernorm(sd, lp["norm2"], f"{dst}.norm2")
        if dec.open_forward_ffn:
            _dense(sd, lp["linear1"], f"{dst}.linear1")
            _dense(sd, lp["linear2"], f"{dst}.linear2")
            _layernorm(sd, lp["norm3"], f"{dst}.norm3")
        _dense(sd, lp["class_embed"], f"{dst}.class_embed")
        for j in range(dec.pose_embed_layer):
            _dense(sd, lp["pose_embed"]["MLP"][f"layers_{j}"],
                   f"{dst}.pose_embed.MLP.layers.{j}")
    return sd
