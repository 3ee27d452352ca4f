"""Set matching of queries to ground-truth people, dense and static-shape.

Port of `mvgformer_tpu/models/matcher.py`. A match is a MatchResult: a
(B, M, K) query-index tensor plus validity masks, which every loss consumes
with static shapes. KNN and threshold ('multiple') matching stay on the
device; the Hungarian assignment runs on the host with scipy, as in JAX
(there through a callback) and in the original repository.

Ties: `jax.lax.top_k` takes the lowest index first among equal values;
`torch.topk` promises no order, so the top-k here is the stable descending
sort of `ops/projattn.py::top_indices`.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mvgformer_tpu_torch.ops.projattn import top_indices


class MatchResult(NamedTuple):
    # for each (batch, gt slot, k): the matched query index
    query_idx: torch.Tensor      # (B, M, K) int64
    # valid gt slots (slot < num_person)
    gt_valid: torch.Tensor       # (B, M) bool
    # per-query positive mask: the query matched a valid gt
    query_mask: torch.Tensor     # (B, Q) bool
    # per-(gt, k) validity where matching fills a variable number of the K
    # slots (threshold matching); None means every slot of a valid gt
    pair_valid: Optional[torch.Tensor] = None  # (B, M, K) bool


def pose_l1_cost(pred_abs: torch.Tensor, gt_abs: torch.Tensor,
                 scale: float = 0.01) -> torch.Tensor:
    """0.01 * L1 distance of flattened (J*3) poses.

    pred_abs (B, Q, J, 3); gt_abs (B, M, J, 3) -> (B, Q, M)."""
    diff = (pred_abs[:, :, None] - gt_abs[:, None]).abs()
    return scale * diff.sum(dim=(-1, -2))


def focal_class_cost(prob: torch.Tensor, alpha: float = 0.25,
                     gamma: float = 2.0) -> torch.Tensor:
    """Per-query focal cost of the positive class: prob (B, Q) -> (B, Q)."""
    neg = (1 - alpha) * (prob ** gamma) * (-torch.log(1 - prob + 1e-8))
    pos = alpha * ((1 - prob) ** gamma) * (-torch.log(prob + 1e-8))
    return pos - neg


def _query_mask(idx: torch.Tensor, valid: torch.Tensor,
                num_queries: int) -> torch.Tensor:
    """(B, Q) bool: queries named by a valid (B, M, K) pair."""
    onehot = F.one_hot(idx, num_queries) * valid[..., None]
    return onehot.sum(dim=(1, 2)) > 0


def knn_match(cost: torch.Tensor, num_person: torch.Tensor,
              k: int) -> MatchResult:
    """The k cheapest queries per gt person. cost (B, Q, M); num_person
    (B,) int."""
    B, Q, M = cost.shape
    idx = top_indices(-cost.transpose(1, 2), k)  # (B, M, K)
    gt_valid = (torch.arange(M, device=cost.device)[None, :]
                < num_person[:, None])
    query_mask = _query_mask(idx, gt_valid[:, :, None].expand_as(idx), Q)
    return MatchResult(query_idx=idx, gt_valid=gt_valid,
                       query_mask=query_mask)


def threshold_match(cost: torch.Tensor, num_person: torch.Tensor,
                    thresh: float, k_cap: int) -> MatchResult:
    """'multiple' matching: every query whose best gt is within `thresh`
    matches that gt; per gt, the k_cap cheapest such queries."""
    B, Q, M = cost.shape
    gt_valid = (torch.arange(M, device=cost.device)[None, :]
                < num_person[:, None])
    # padded gt slots must not attract the argmin
    cost = torch.where(gt_valid[:, None, :], cost, float("inf"))
    best_cost, best_gt = cost.min(dim=-1)  # (B, Q)
    is_match = best_cost < thresh
    choose = F.one_hot(best_gt, M).bool() & is_match[..., None]
    masked = torch.where(choose.transpose(1, 2), cost.transpose(1, 2),
                         float("inf"))  # (B, M, Q)
    idx = top_indices(-masked, k_cap)
    pair_valid = torch.isfinite(torch.gather(masked, -1, idx))
    query_mask = _query_mask(idx, pair_valid & gt_valid[:, :, None], Q)
    return MatchResult(query_idx=idx,
                       gt_valid=gt_valid & pair_valid.any(-1),
                       query_mask=query_mask,
                       pair_valid=pair_valid & gt_valid[:, :, None])


def hungarian_match_host(cost: np.ndarray, num_person: np.ndarray
                         ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Host Hungarian assignment (scipy): one (query_ids, gt_ids) pair per
    batch item, over the first num_person gt columns."""
    from scipy.optimize import linear_sum_assignment

    out = []
    for b in range(cost.shape[0]):
        n = int(num_person[b])
        q_ids, g_ids = linear_sum_assignment(cost[b][:, :n])
        out.append((q_ids.astype(np.int64), g_ids.astype(np.int64)))
    return out


def hungarian_to_match_result(pairs, B: int, Q: int, M: int,
                              device=None) -> MatchResult:
    """The host Hungarian output as a dense MatchResult (K = 1)."""
    query_idx = np.zeros((B, M, 1), dtype=np.int64)
    gt_valid = np.zeros((B, M), dtype=bool)
    query_mask = np.zeros((B, Q), dtype=bool)
    for b, (q_ids, g_ids) in enumerate(pairs):
        for q, g in zip(q_ids, g_ids):
            query_idx[b, g, 0] = q
            gt_valid[b, g] = True
            query_mask[b, q] = True
    return MatchResult(*(torch.from_numpy(a).to(device)
                         for a in (query_idx, gt_valid, query_mask)))


def hungarian_match(cost: torch.Tensor,
                    num_person: torch.Tensor) -> MatchResult:
    """Hungarian assignment of a (B, Q, M) cost on the host, as a
    MatchResult on the cost's device; the counterpart of JAX's
    `hungarian_match_callback`. The assignment takes no gradient."""
    B, Q, M = cost.shape
    pairs = hungarian_match_host(
        cost.detach().double().cpu().numpy(), num_person.cpu().numpy())
    return hungarian_to_match_result(pairs, B, Q, M, device=cost.device)
