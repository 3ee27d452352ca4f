"""Library yardsticks: the one PyTorch call that computes a kernel's function,
timed beside the kernel (`library_ms` in `chip_smoke.py` and the probes).
The port never computes with these.

B3's forward, out[p, s] = sum_c tables[p, idx[p, s], cD:(c+1)D] * w4[p, s, c],
is F.embedding_bag in mode 'sum' over the tables viewed as (NH * R * 4, D)
rows, one bag of 4 rows per sample with w4 as per-sample weights; its
autograd gives B3's backward (dense grad of the tables, grad of the
weights).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def embedding_bag_operands(tables: torch.Tensor, idx: torch.Tensor,
                           w4: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """(weight (NH*R*4, D), input (NH*S*4,) int64, offsets (NH*S,) int64,
    per_sample_weights (NH*S*4,)) for B3's contract. Build them before a
    clock starts: at one flagship level the input alone is 157 MB."""
    NH, R, C = tables.shape
    S = idx.shape[1]
    dev = tables.device
    first = (torch.arange(NH, device=dev)[:, None] * R + idx.long()) * 4
    rows = (first[..., None] + torch.arange(4, device=dev)).reshape(-1)
    offsets = torch.arange(0, NH * S * 4, 4, device=dev)
    return (tables.view(NH * R * 4, C // 4), rows, offsets,
            w4.reshape(-1).to(tables.dtype))


def embedding_bag_reduce(weight: torch.Tensor, rows: torch.Tensor,
                         offsets: torch.Tensor, psw: torch.Tensor,
                         NH: int) -> torch.Tensor:
    """B3's forward as one library call: (NH, S, D)."""
    out = F.embedding_bag(rows, weight, offsets, mode="sum",
                          per_sample_weights=psw)
    return out.view(NH, -1, weight.shape[1])
