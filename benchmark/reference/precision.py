"""Where the reference rounds: float32 (no rounding) or a control's TF32
or float8.

The reference calls `act` on every tensor that the served model holds in
its compute dtype (the inputs and outputs of its convolutions and compute-
dtype linear layers, the LayerNorm outputs, the sampled values and their
weights) and `weight` on every weight that it casts to that dtype. In
float32 both return the tensor as it is. The control (`Float8`) rounds
them to float8 e4m3, and in training their gradients to e5m2, with one
scale per tensor: the step below a configuration that states bfloat16.
`TF32` rounds them to TF32's 10-bit mantissa, and runs the card's matmuls
and convolutions in TF32 besides: the step below a configuration that
states float32 with TF32 off. A configuration file names its control
(`control`, float8 where it names none).

`products(tf32)` runs a block with the card's float32 matmuls and
convolutions in TF32 or in full float32, and puts the flags back after.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


class Float32:
    name = "float32"
    tf32 = False

    @staticmethod
    def act(x: torch.Tensor) -> torch.Tensor:
        return x.float()

    weight = act


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """x rounded to a float8 type under one scale, the largest magnitude
    mapped to `top`, and back to float32."""
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (x / scale).to(dtype).float() * scale


class _Float8(torch.autograd.Function):
    """Values rounded to e4m3, their gradients to e5m2, each under one
    scale per tensor: float8 training's two types."""

    @staticmethod
    def forward(ctx, x):
        return _round(x.float(), torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g.float(), torch.float8_e5m2, E5M2_MAX)


class Float8:
    name = "float8_e4m3"
    tf32 = False
    act = staticmethod(_Float8.apply)
    weight = staticmethod(_Float8.apply)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest float32 of a 10-bit mantissa (ties to
    even), as TF32 holds it."""
    bits = x.float().contiguous().view(torch.int32)
    even = (bits >> 13) & 1
    return ((bits + 0xFFF + even) & ~0x1FFF).view(torch.float32)


class TF32:
    name = "tf32"
    tf32 = True
    act = staticmethod(_tf32)
    weight = staticmethod(_tf32)


PRECISIONS = {p.name: p for p in (Float32, TF32, Float8)}


def control(spec: dict):
    """The configuration's control precision."""
    return PRECISIONS[spec.get("control", Float8.name)]


@contextlib.contextmanager
def products(tf32: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
