"""Multi-head dot-product attention with torch's packed parameter layout.

The port's counterpart of flax's `nn.MultiHeadDotProductAttention` as the
JAX package's decoders use it (no mask, no dropout on the attention): the
query is scaled by 1 / sqrt(head dim), softmax over the keys, and the heads
are joined by an output projection. The parameters are laid out as torch's
`nn.MultiheadAttention` holds them, `in_proj_weight` (3C, C) with the query,
key and value rows stacked, `in_proj_bias` (3C,) and `out_proj`, so that an
original-repo checkpoint loads by name.

On the card the attention runs through `F.scaled_dot_product_attention`:
at the MvP baseline's full width it attends over 15,360 tokens, whose score
matrix would take 15,360^2 x 8 heads x 2 bytes = 3.8 GB per layer in bf16.
On the CPU it is the plain softmax(q k^T) v in the compute dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mvgformer_tpu_torch.models.mlp import Dense, init_linear_


class MultiheadAttention(nn.Module):
    """Self- or cross-attention over (B, L, C) inputs."""

    def __init__(self, d_model: int, n_heads: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"{n_heads} heads")
        self.d_model, self.n_heads = d_model, n_heads
        self.dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        # flax's DenseGeneral default: lecun normal over fan_in C, per
        # projection
        for i in range(3):
            init_linear_(self.in_proj_weight[i * d_model:(i + 1) * d_model],
                         "lecun", generator)
        self.out_proj = Dense(d_model, d_model, dtype, generator=generator)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor) -> torch.Tensor:
        B, Lq, C = query.shape
        H, hd = self.n_heads, C // self.n_heads
        w = self.in_proj_weight.to(self.dtype)
        b = self.in_proj_bias.to(self.dtype)

        def heads(x, i):
            y = F.linear(x.to(self.dtype), w[i * C:(i + 1) * C],
                         b[i * C:(i + 1) * C])
            return y.reshape(B, -1, H, hd).transpose(1, 2)  # (B, H, L, hd)

        q, k, v = heads(query, 0), heads(key, 1), heads(value, 2)
        if q.is_cuda:
            out = F.scaled_dot_product_attention(q, k, v)
        else:
            q = q / torch.sqrt(torch.tensor(float(hd), dtype=q.dtype))
            attn = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
            out = attn @ v
        return self.out_proj(out.transpose(1, 2).reshape(B, Lq, C))
