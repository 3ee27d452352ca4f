"""Weights drawn on the device from the seed, by parameter name and shape.

One normal draw and one uniform draw on the card cover every tensor of a
model's state dict, in the order of its names:

  * `*.running_var`: uniform in [0.8, 1.2]; `*.running_mean`: N(0, 0.05);
  * `*embedding.weight`: N(0, 1), the query embeddings' own scale;
  * `*sampling_offsets.bias`: N(0, 3), offsets of a few pixels;
  * any other tensor of two or more axes: N(0, 1 / fan_in), fan_in the
    product of all axes but the first (LeCun's normal);
  * any other one-axis `weight` (a norm's scale): 1 + N(0, 0.05); any
    other `bias`: N(0, 0.02).

Integer buffers are left as they are. The same dict of float32 tensors is
loaded into the measured model and handed to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch


def rule(name: str, shape: Tuple[int, ...]) -> Tuple[str, float, float]:
    """(draw, scale, shift) of one tensor: the value is shift + scale x a
    standard normal ('normal') or a uniform in [0, 1) ('uniform')."""
    if name.endswith("running_var"):
        return "uniform", 0.4, 0.8
    if name.endswith("running_mean"):
        return "normal", 0.05, 0.0
    if name.endswith("embedding.weight"):
        return "normal", 1.0, 0.0
    if name.endswith("sampling_offsets.bias"):
        return "normal", 3.0, 0.0
    if len(shape) >= 2:
        return "normal", 1.0 / math.sqrt(math.prod(shape[1:])), 0.0
    if name.endswith("weight"):
        return "normal", 0.05, 1.0
    return "normal", 0.02, 0.0


def draw(shapes: Mapping[str, Tuple[int, ...]], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """float32 tensors for every name of `shapes`, from `seed`."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    rules = {n: rule(n, tuple(s)) for n, s in shapes.items()}
    sizes = {kind: sum(math.prod(shapes[n]) for n, r in rules.items()
                       if r[0] == kind) for kind in ("normal", "uniform")}
    pools = {"normal": torch.randn(sizes["normal"], generator=gen,
                                   device=device),
             "uniform": torch.rand(sizes["uniform"], generator=gen,
                                   device=device)}
    used = {"normal": 0, "uniform": 0}
    out = {}
    for name, (kind, scale, shift) in rules.items():
        n = math.prod(shapes[name])
        flat = pools[kind][used[kind]:used[kind] + n]
        used[kind] += n
        out[name] = (flat * scale + shift).reshape(shapes[name])
    return out


def float_shapes(module: torch.nn.Module) -> Dict[str, Tuple[int, ...]]:
    """The names and shapes of a module's floating-point state."""
    return {k: tuple(v.shape) for k, v in module.state_dict().items()
            if v.is_floating_point()}


def load(module: torch.nn.Module, weights: Mapping[str, torch.Tensor]):
    """Copy `weights` into the module's state, every floating entry."""
    state = module.state_dict()
    missing = [k for k in float_shapes(module) if k not in weights]
    if missing:
        raise KeyError(f"no drawn weights for {missing[:5]}")
    with torch.no_grad():
        for k, v in weights.items():
            state[k].copy_(v)
