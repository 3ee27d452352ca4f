"""Multi-scale deformable sampling on the card: the Hopper kernel's wrapper.

`deform_sample` has the contract of `ops/sampling.py::deform_sample`.

    * A CPU tensor goes to that plain PyTorch version.
    * A CUDA tensor launches the hand-written kernel
      `csrc/deform_sample.cu` (forward only) or raises. Nothing falls back.
      Its vector instances (a thread per 16-byte vector) run where
      `_build.vector_width` allows them, its generic instance (a thread per
      element) everywhere else.

The kernel is compiled with nvcc at first use into `build/kernels/` at the
root of the checkout (`ops/_build.py`) and bound with ctypes.
`deform_sample.launches` counts kernel launches; nothing else changes it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Sequence, Tuple

import torch

from mvgformer_tpu_torch.ops import _build, sampling

_SRC = _build.CSRC / "deform_sample.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_LEVELS = 4


def build() -> Path:
    """Compile the kernel unless the library for this source exists."""
    return _build.build(_SRC)


_FORWARD = _build.Launcher(
    _SRC, "mvg_deform_sample_forward",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
    + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
       ctypes.c_void_p])


def _check(value, spatial_shapes, sampling_locations, attention_weights):
    if value.dim() != 4:
        raise ValueError(f"value must be (N, Len_in, H, D), got "
                         f"{tuple(value.shape)}")
    N, Len_in, H, D = value.shape
    if sampling_locations.dim() != 6 or sampling_locations.shape[-1] != 2:
        raise ValueError("sampling_locations must be (N, Lq, H, L, P, 2), "
                         f"got {tuple(sampling_locations.shape)}")
    _, Lq, _, L, P, _ = sampling_locations.shape
    if (tuple(sampling_locations.shape[:3]) != (N, Lq, H)
            or tuple(attention_weights.shape) != (N, Lq, H, L, P)):
        raise ValueError(
            f"shapes disagree: value {tuple(value.shape)}, locations "
            f"{tuple(sampling_locations.shape)}, weights "
            f"{tuple(attention_weights.shape)}")
    if len(spatial_shapes) != L or not 1 <= L <= _MAX_LEVELS:
        raise ValueError(f"{L} levels with spatial shapes {spatial_shapes}")
    if sum(h * w for h, w in spatial_shapes) != Len_in:
        raise ValueError(f"spatial shapes {spatial_shapes} do not sum to "
                         f"Len_in = {Len_in}")
    devices = {value.device, sampling_locations.device,
               attention_weights.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


def deform_sample(value: torch.Tensor,
                  spatial_shapes: Sequence[Tuple[int, int]],
                  sampling_locations: torch.Tensor,
                  attention_weights: torch.Tensor) -> torch.Tensor:
    """(N, Lq, H*D) deformable sampling; see `ops/sampling.py`.

    value (N, Len_in, H, D) float32 or bfloat16; sampling_locations
    (N, Lq, H, L, P, 2) float32; attention_weights (N, Lq, H, L, P) in the
    dtype of value. On CUDA all three must be contiguous, and none may
    require grad (the backward kernel is not written yet).
    """
    _check(value, spatial_shapes, sampling_locations, attention_weights)
    if value.device.type == "cpu":
        return sampling.deform_sample(value, spatial_shapes,
                                      sampling_locations, attention_weights)
    if value.device.type != "cuda":
        raise ValueError(f"unsupported device {value.device}")
    if any(t.requires_grad for t in (value, sampling_locations,
                                     attention_weights)):
        raise NotImplementedError(
            "deform_sample has no backward kernel yet; call it under "
            "torch.no_grad() or on tensors that do not require grad")
    if value.dtype not in _DTYPE_CODE:
        raise TypeError(f"value must be float32 or bfloat16, got "
                        f"{value.dtype}")
    if attention_weights.dtype != value.dtype:
        raise TypeError(f"attention_weights are {attention_weights.dtype}, "
                        f"value is {value.dtype}")
    if sampling_locations.dtype != torch.float32:
        raise TypeError("sampling_locations must be float32, got "
                        f"{sampling_locations.dtype}")
    for name, t in (("value", value), ("sampling_locations",
                                       sampling_locations),
                    ("attention_weights", attention_weights)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    N, Len_in, H, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    levels, start = [], 0
    for h, w in spatial_shapes:
        levels += [int(h), int(w), start]
        start += int(h) * int(w)
    out = torch.empty((N, Lq, H * D), dtype=value.dtype, device=value.device)
    _FORWARD(value, value.data_ptr(), sampling_locations.data_ptr(),
             attention_weights.data_ptr(), out.data_ptr(), N, Len_in, H, D,
             Lq, L, P, (ctypes.c_int * len(levels))(*levels),
             _DTYPE_CODE[value.dtype],
             _build.vector_width(D, value.element_size(), value,
                                 sampling_locations, attention_weights, out))
    deform_sample.launches += 1
    return out


deform_sample.launches = 0
