"""Model FLOPs of a frame, counted from a configuration's shapes.

`flops/<TRANSFORMER>.py` holds the count of one model family; its
`serve_frame(settings)` gives one served frame's FLOPs by kind: `matmul`
(the convolutions, the linear layers and the attention products; a
multiply-add counts two), `sample` (the bilinear samples: four corners and
the weighted sum, 10 FLOPs per channel) and `solve` (the DLT's Gram
matrices and Jacobi sweeps). Elementwise work (norms, activations,
softmaxes, undistortion) is not counted. The counts depend on the shapes
alone, so they read the same work whatever implements a kernel.
"""

from __future__ import annotations

import importlib
from typing import Dict


def serve_frame_parts(settings: dict) -> Dict[str, float]:
    """One served frame's FLOPs of the configuration, by kind."""
    family = importlib.import_module(
        f"benchmark.flops.{settings['TRANSFORMER']}")
    return family.serve_frame(settings)


def serve_frame(settings: dict) -> float:
    """One served frame's FLOPs of the configuration."""
    return float(sum(serve_frame_parts(settings).values()))


def train_step(settings: dict) -> float:
    """One training step's FLOPs per batch item: the frozen backbone's
    forward and the decoder's forward and backward (twice the forward),
    with no top-K or point-top-m; remat's recompute is not counted."""
    family = importlib.import_module(
        f"benchmark.flops.{settings['TRANSFORMER']}")
    return float(sum(family.train_step(settings).values()))
