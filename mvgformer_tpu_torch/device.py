"""Device and precision helpers.

The port's entry points build on the card by default (`resolve_device`).

Geometry is always float32. On the card, float32 matrix products and cuDNN
convolutions may silently run in TF32 (about three decimal digits); the JAX
reference pins its camera math to full precision
(`mvgformer_tpu/geometry/cameras.py`, `Precision.HIGHEST`), so float32
comparisons against it turn TF32 off with `strict_float32()`.
"""

from __future__ import annotations

import functools
import subprocess

import torch

from mvgformer_tpu_torch.config import Config


def resolve_device(device) -> torch.device:
    """The device an entry point builds on: the card unless the caller
    asks for the CPU. A CUDA device with no card raises; nothing carries
    on on the CPU in its place."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but no CUDA card is "
            f"available: pass device='cpu' to run on the CPU")
    return device


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    # a normal tensor even when first asked for under inference_mode, so
    # a later training step may use it
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def constant(values, dtype: torch.dtype = torch.float32,
             device="cpu") -> torch.Tensor:
    """A small constant tensor of `values` (a number or nested sequences
    of numbers) on `device`, made once per (values, dtype, device) and
    then reused: on the card a host-to-device copy waits for the stream,
    so a step that made its constants anew would synchronize with the
    device each time. The tensor is shared: never write into it."""
    def freeze(v):
        return tuple(map(freeze, v)) if isinstance(v, (list, tuple)) else v

    return _constant(freeze(values), dtype, torch.device(device))


def card_line() -> str:
    """The first card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them: a card
    set below its maximum power runs slower under load, so every number
    measured on it is kept beside this line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def strict_float32() -> None:
    """Run float32 matmuls and convolutions in full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def compute_dtype(cfg: Config) -> torch.dtype:
    """`PARALLEL.COMPUTE_DTYPE` as a torch dtype."""
    name = cfg.PARALLEL.COMPUTE_DTYPE
    if name == "bfloat16":
        return torch.bfloat16
    if name == "float32":
        return torch.float32
    raise ValueError(f"unsupported PARALLEL.COMPUTE_DTYPE: {name!r}")
