"""The statistics of a measured window."""

from __future__ import annotations

import statistics
from typing import Sequence, Tuple

import numpy as np


def rate(spans: Sequence[Tuple[float, float, int]], seconds: float) -> float:
    """All the frames of the (start, end, frames) spans completed inside
    the window over all the seconds of the window."""
    return sum(n for _, _, n in spans) / seconds


def p95_ms(spans: Sequence[Tuple[float, float, int]]) -> float:
    """The 95th percentile of every span's latency, in ms (numpy's linear
    interpolation between order statistics)."""
    return float(np.percentile([1e3 * (e - s) for s, e, _ in spans], 95))


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median (Python's `statistics.quantiles`, n=4)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def quarters(ends: Sequence[float], per: int, seconds: float) -> list:
    """The rate in each quarter of a window of `seconds`: the units that
    ended in it (`ends`, seconds from the window's start), `per` each,
    over a quarter's seconds."""
    q = seconds / 4
    counts = [0] * 4
    for end in ends:
        counts[min(int(end / q), 3)] += per
    return [c / q for c in counts]
