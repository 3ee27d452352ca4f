"""How `correct` is decided for a served frame: the preds that the measured
window produced, on a sample of its frames drawn from the seed, against the
plain float32 reference on the same weights and frames.

The numbers read:

  * `score_gap`: the largest gap between a pred's score and the
    reference's, over every query of every sampled frame;
  * `pose_gap_mm`: the largest distance in mm between a joint of the pred
    and the reference's;
  * `frame_pose_gap_p<q>_mm`, `frame_score_gap_p<q>`: the q-th percentile
    (q 50, 90, 99) of those gaps over one frame's kept queries, the
    largest over the sampled frames: steady within a frame, and a frame
    whose answer is wrong moves its own;
  * MVGFormer only, where layer 1 keeps the top K queries: `topk_count`,
    how far the number of queries the pred kept lies from K in any frame,
    and `topk_outside`, how many kept queries have a reference layer-1
    score more than TOPK_BAND below the reference's own K-th best (both
    exact, limit 0). The reference then runs the later layers on the
    kept queries, so that a near tie at the K-th score, which rounding
    may break either way, does not change which rows are compared; the
    largest margin of such a tie is read as `topk_margin`.
  * MVGFormer only: a query whose class probability lies within
    MASK_BAND of the threshold below which a layer masks it, in any layer
    of the reference, is a near tie: rounding may mask it on one side and
    not on the other, and its later layers then differ. Near ties are left
    out of every gap; the most of them in one frame is read as
    `near_ties`.

The numbers a run compares are those its limits file names; the others
are readings, which `readings.py` reports for setting the limits.

A pred's kept queries are its rows whose score is above SELECT_FLOOR: a
dropped query's row holds the score of a class probability of 0, which the
clamped inverse sigmoid maps to 1e-5 / (1 + 1e-5).
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference import model as ref_model
from benchmark.reference import precision
from benchmark.reference.precision import Float32, products

SELECT_FLOOR = 2e-5
FRAME_PERCENTILES = (50, 90, 99)
# Tie bands, set from readings on the card (PERF.md sec. 2). A kept query
# may lie this far below the reference's K-th best layer-1 score: the
# program's largest margin read 0.00105, the float8 control's smallest
# 0.00244.
TOPK_BAND = 0.0018
# A class probability this near the masking threshold is a near tie: twice
# the program's largest score gap (0.00295) over the reference's.
MASK_BAND = 0.006


def family(spec: dict):
    """The reference's frame function of the configuration's model family
    (`reference/<TRANSFORMER>.py`)."""
    return importlib.import_module(
        f"benchmark.reference.{spec['settings']['TRANSFORMER']}").frame


def sample(units: int, seed: int, count: int) -> List[int]:
    """`count` positions of the window's `units` results, drawn from the
    seed (all of them where there are fewer)."""
    rng = np.random.default_rng([int(seed), 2])
    if units <= count:
        return list(range(units))
    return sorted(rng.choice(units, size=count, replace=False).tolist())


def readings(spec: dict, weights: dict, ring, judged: Sequence[
        Tuple[Sequence[int], np.ndarray]], device) -> Dict[str, float]:
    """The numbers compared, over the judged (ring indices, pred
    (B, Q, J, 5)) results, one reference frame at a time, with the
    percentiles of the kept rows' gaps beside them (the limits file names
    the numbers a run compares)."""
    s = spec["settings"]
    dq = s["TRANSFORMER"] == "dq_transformer"
    K = s.get("DECODER.inference_topk_queries")
    net = ref_model.Net(weights, Float32)
    out = {}
    if dq and K:
        out.update(topk_count=0.0, topk_margin=0.0)
    with torch.no_grad(), products(False):
        for indices, pred in judged:
            for row, index in enumerate(indices):
                got = torch.from_numpy(np.asarray(pred[row])).to(device)
                frame = ring.frame([index], device)
                rows = got[:, 0, 4] > SELECT_FLOOR
                fair = torch.ones_like(rows)
                if dq:
                    kept = None
                    if K:
                        kept = torch.nonzero(rows)[:, 0]
                        out["topk_count"] = max(out["topk_count"],
                                                float(abs(kept.numel() - K)))
                        if kept.numel() != K:
                            kept = None
                    history: list = []
                    want = ref_model.dq_frame(
                        spec, net, frame, None if kept is None
                        else kept[None], history=history)
                    fair = ~near_ties(history, want["select"], s)
                    out["near_ties"] = max(out.get("near_ties", 0.0),
                                           float((~fair).sum()))
                    if K:
                        scores = want["layer1_scores"][0]
                        kth = torch.topk(scores, K).values[-1]
                        chosen = want["select"][0]
                        out["topk_margin"] = max(out["topk_margin"], float(
                            torch.clamp(kth - scores[chosen], min=0).max()))
                        out["topk_outside"] = max(
                            out.get("topk_outside", 0.0), float(
                                (scores[chosen] < kth - TOPK_BAND).sum()))
                else:
                    want = family(spec)(spec, net, frame)
                want = want["pred"][0]
                score = (got[..., 0, 4] - want[..., 0, 4]).abs()[fair]
                pose = torch.linalg.norm(got[..., :3] - want[..., :3], dim=-1)
                pose = pose[rows & fair]
                per = {"score_gap": score.max(), "pose_gap_mm": pose.max()
                       if pose.numel() else torch.tensor(0.0)}
                for q in FRAME_PERCENTILES:
                    per[f"frame_pose_gap_p{q}_mm"] = quantile(pose, q)
                    per[f"frame_score_gap_p{q}"] = quantile(
                        score[rows[fair]], q)
                for k, v in per.items():
                    v = float(v)
                    out[k] = max(out.get(k, 0.0),
                                 v if np.isfinite(v) else np.inf)
    return out


def near_ties(history: list, select: torch.Tensor, s: dict) -> torch.Tensor:
    """(Q,) the queries of one frame whose class probability lies within
    MASK_BAND of the masking threshold in any layer of the reference
    (`history`: layer 1 over every query, the later layers over
    `select`'s)."""
    threshold = s["MULTI_PERSON.THRESHOLD"]
    near = [((h["class_prob"][0, :, 1] - threshold).abs() < MASK_BAND)
            for h in history]
    dense = near[0].clone()
    for later in near[1:]:
        dense[select[0]] |= later
    return dense


def quantile(x: torch.Tensor, q: float) -> float:
    """The q-th percentile of x's entries (inf where there are none)."""
    x = x.reshape(-1).double()
    return float(torch.quantile(x, q / 100)) if x.numel() else np.inf


def control(spec: dict, weights: dict, ring, units: Sequence[Sequence[int]],
            device) -> List[Tuple[Sequence[int], np.ndarray]]:
    """The control's results: the reference in the configuration's control
    precision (`precision.control`) in the program's place, its own top-K,
    on the same frames."""
    prec = precision.control(spec)
    net = ref_model.Net(weights, prec)
    out = []
    with torch.no_grad(), products(prec.tf32):
        for indices in units:
            preds = [family(spec)(spec, net, ring.frame([i], device))[
                "pred"][0].cpu().numpy() for i in indices]
            out.append((list(indices), np.stack(preds)))
    return out
