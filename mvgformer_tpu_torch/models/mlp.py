"""Dense layers with a compute dtype, the ReLU MLP and the offset net.

Port of `mvgformer_tpu/models/mlp.py`. Parameters are float32; `Dense`
casts its input and parameters to its compute dtype at call time, as a flax
`nn.Dense(dtype=...)` does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def init_linear_(weight: torch.Tensor, init: str,
                 generator: Optional[torch.Generator] = None) -> None:
    """Fill a (out, in) weight with a flax initializer's distribution:
    'lecun' (flax's Dense default: truncated normal, std 1/sqrt(fan_in)),
    'xavier' (uniform) or 'zeros'."""
    with torch.no_grad():
        if init == "zeros":
            weight.zero_()
        elif init == "xavier":
            nn.init.xavier_uniform_(weight, generator=generator)
        elif init == "lecun":
            fan_in = math.prod(weight.shape[1:])
            # flax rescales so the truncated (+-2 sigma) normal keeps the
            # variance 1/fan_in
            std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
        else:
            raise ValueError(f"unknown init {init!r}")


class Dense(nn.Linear):
    """nn.Linear computing in `dtype`, initialized like flax (zero bias)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, init: str = "lecun",
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features)
        self.dtype = dtype
        init_linear_(self.weight, init, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class MLP(nn.Module):
    """ReLU MLP with `num_layers` Dense layers (names `layers.{i}`)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Dense(dims[i], dims[i + 1], dtype=dtype, generator=generator)
            for i in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class OffsetNet(nn.Module):
    """Per-view 2D offset + confidence head: a 3-output MLP whose first two
    channels are the 2D offset and the third the confidence logit."""

    def __init__(self, d_model: int, num_layers: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.MLP = MLP(d_model, d_model, 3, num_layers, dtype=dtype,
                       generator=generator)

    def forward(self, feature: torch.Tensor):
        out = self.MLP(feature)
        return out[..., :2], out[..., 2]
