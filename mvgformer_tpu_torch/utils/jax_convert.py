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
    MultiHeadDotProductAttention query/key/value kernels (C, heads, C/heads)
    and biases (heads, C/heads), out kernel (heads, C/heads, C)
                                              -> in_proj_weight (3C, C),
                                                 in_proj_bias (3C,),
                                                 out_proj (torch's
                                                 nn.MultiheadAttention)

Everything but the backbone is carried by walking the flax tree, the
module names turned into torch's: `layer_{i}` of the DQ decoder and of the
MvP model -> `decoder.layers.{i}` (`layer_shared` stays), `layers_{j}` ->
`layers.{j}`, the MvP heads `class_embed_{i}` / `pose_embed_{i}` ->
`class_embed.{i}` / `pose_embed.{i}`. This covers both top models
(TRANSFORMER) and every decoder option.
"""

from __future__ import annotations

import re
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


def _mha(sd, node, name):
    """flax MultiHeadDotProductAttention -> torch's packed layout."""
    def flat(x):
        return np.asarray(x).reshape(np.asarray(x).shape[0], -1)

    sd[name + ".in_proj_weight"] = _t(np.concatenate(
        [flat(node[k]["kernel"]).T for k in ("query", "key", "value")]))
    sd[name + ".in_proj_bias"] = _t(np.concatenate(
        [np.asarray(node[k]["bias"]).reshape(-1)
         for k in ("query", "key", "value")]))
    out = np.asarray(node["out"]["kernel"])
    sd[name + ".out_proj.weight"] = _t(out.reshape(-1, out.shape[-1]).T)
    sd[name + ".out_proj.bias"] = _t(node["out"]["bias"])


def _torch_name(key: str) -> str:
    """A flax module name -> its torch attribute path."""
    m = re.fullmatch(r"(layer|layers|class_embed|pose_embed)_(\d+)", key)
    if m is None:
        return key
    return {"layer": "layers"}.get(m.group(1), m.group(1)) + "." + m.group(2)


def module_state_dict(node: Mapping, prefix: str = ""
                      ) -> Dict[str, torch.Tensor]:
    """The state_dict of one flax module's params subtree (no batch
    statistics), its names prefixed by `prefix`."""
    sd: Dict[str, torch.Tensor] = {}
    for key, child in node.items():
        _walk(sd, child, prefix + _torch_name(key))
    return sd


def _walk(sd, node, name):
    """Every Dense, LayerNorm and attention module under `node`."""
    if {"query", "key", "value", "out"} <= set(node):
        _mha(sd, node, name)
    elif "kernel" in node:
        _dense(sd, node, name)
    elif "scale" in node:
        _layernorm(sd, node, name)
    else:
        for key, child in node.items():
            _walk(sd, child, f"{name}.{_torch_name(key)}")


def _bn(sd, params, stats, name):
    sd[name + ".weight"] = _t(params["scale"])
    sd[name + ".bias"] = _t(params["bias"])
    sd[name + ".running_mean"] = _t(stats["mean"])
    sd[name + ".running_var"] = _t(stats["var"])
    sd[name + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def port_state_dict_from_jax(variables: Mapping,
                             cfg: Config) -> Dict[str, torch.Tensor]:
    """flax variables {'params', 'batch_stats'} -> the state_dict of the
    top model of cfg.TRANSFORMER."""
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

    for key, node in params.items():
        if key in ("backbone", "joint_embedding", "instance_embedding"):
            continue
        # the MvP model's layers sit at the top of its tree
        prefix = "decoder." if re.fullmatch(r"layer_\d+", key) else ""
        sd.update(module_state_dict({key: node}, prefix))
    return sd
