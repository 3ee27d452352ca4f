"""Projective attention (ProjAttn) as an nn.Module.

Port of `mvgformer_tpu/ops/projattn.py` with the parameter names of the
original torch module (sampling_offsets / attention_weights / rayconv /
output_proj) and the same forward math, including the row-major
reinterpretation of the stacked per-level offsets: with
num_feature_levels = 1 and several feature maps, the (level, head, point)
axes are scrambled in a trained-in way that converted checkpoints rely on.

Deformable sampling goes through `ops.deform_attn.deform_sample`, which runs
the Hopper kernel on CUDA tensors; with a window plan (layer 1 of the
windowed serving path) it goes through `ops.window_sampling.window_sample`
and the window kernels instead. In training (`train=True`) it goes through
the differentiable corner-table sampler `ops.sampling.deform_sample_corner`
and its table-build and gather-reduce kernels, as JAX's ProjAttn samples
through `deform_sample_corner` whenever it trains. Point-top-m (serving
only) goes through `ops.point_topm.point_topm`, one kernel launch per call
on CUDA tensors.

`posembed_mode` (DECODER.projattn_posembed_mode, the MvP baseline's):
'use_rayconv' concatenates each pixel's camera ray direction (3 channels)
and 'use_2d_coordconv' its normalized 2D coordinates (2 channels) to the
flattened features before the value projection `rayconv`, which then takes
d_model + 3 or d_model + 2 inputs; 'ablation_not_use_rayconv' adds nothing.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mvgformer_tpu_torch.device import constant
from mvgformer_tpu_torch.models.mlp import Dense
from mvgformer_tpu_torch.ops.deform_attn import deform_sample
from mvgformer_tpu_torch.ops.point_topm import point_topm as select_point_topm
from mvgformer_tpu_torch.ops.sampling import (bilinear_sample,
                                              deform_sample_corner)
from mvgformer_tpu_torch.ops.window_sampling import WindowPlan, window_sample
from mvgformer_tpu_torch.utils.profiling import span


def radial_offsets_bias(n_heads: int, n_levels: int,
                        n_points: int) -> torch.Tensor:
    """The radial-grid init of the sampling-offsets bias, flat
    (n_heads * n_levels * n_points * 2,)."""
    thetas = torch.arange(n_heads, dtype=torch.float32) * (
        2.0 * math.pi / n_heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], dim=-1)
    grid = grid / grid.abs().amax(dim=-1, keepdim=True)
    grid = grid.reshape(n_heads, 1, 1, 2).repeat(1, n_levels, n_points, 1)
    scale = torch.arange(1, n_points + 1, dtype=torch.float32)
    return (grid * scale[None, None, :, None]).reshape(-1)


# the channels each posembed_mode adds to the value projection's input
POSEMBED_CHANNELS = {"ablation_not_use_rayconv": 0, "use_rayconv": 3,
                     "use_2d_coordconv": 2}


def top_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, lowest index
    first among ties (the rule of jax.lax.top_k; torch.topk has none)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


class ProjAttn(nn.Module):
    """Projective attention over multi-scale per-view feature maps."""

    def __init__(self, d_model: int = 256, n_levels: int = 1,
                 n_heads: int = 8, n_points: int = 8,
                 posembed_mode: str = "ablation_not_use_rayconv",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if posembed_mode not in POSEMBED_CHANNELS:
            raise ValueError(f"unknown projattn_posembed_mode "
                             f"{posembed_mode!r}")
        self.pos_channels = POSEMBED_CHANNELS[posembed_mode]
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        self.dtype = dtype
        # offsets and weights are float32 layers whatever the compute dtype
        self.sampling_offsets = Dense(d_model, n_heads * n_levels * n_points
                                      * 2, dtype=torch.float32, init="zeros")
        self.attention_weights = Dense(d_model, n_heads * n_levels * n_points,
                                       dtype=torch.float32, init="zeros")
        self.rayconv = Dense(d_model + self.pos_channels, d_model,
                             dtype=dtype, init="xavier", generator=generator)
        self.output_proj = Dense(d_model, d_model, dtype=dtype,
                                 init="xavier", generator=generator)
        with torch.no_grad():
            self.sampling_offsets.bias.copy_(
                radial_offsets_bias(n_heads, n_levels, n_points))

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                src_views: Sequence[torch.Tensor],
                spatial_shapes: Sequence[Tuple[int, int]],
                window_plan: Optional[WindowPlan] = None,
                offset_clamp_px: Optional[float] = None,
                point_topm: Optional[int] = None,
                train: bool = False,
                camera_ray_embeds: Optional[torch.Tensor] = None,
                taps: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """
        Args:
            query:            (N, Lq, C) per-view queries (pos-embedded).
            reference_points: (N, Lq, L, 2) per-level [0, 1] centers.
            src_views:        per-level (N, h, w, C) maps (NHWC).
            spatial_shapes:   static ((h, w), ...) matching src_views.
            window_plan:      rig-static layer-1 plan: sample through the
                              window kernels (ops/window_sampling.py).
            offset_clamp_px:  clamp the learned offsets to +-this many
                              pixels of each level
                              (DECODER.layer1_offset_clamp).
            point_topm:       keep only the top-m of P points per
                              (query, head, level) by attention weight.
            train:            sample through the differentiable corner
                              sampler (no window plan then).
            camera_ray_embeds: (N, sum hw, 3) ray directions (use_rayconv)
                              or (N, sum hw, 2) coordinates
                              (use_2d_coordconv); None otherwise.
            taps:             the debug taps: where given, a dict to which
                              this call appends its sampling locations
                              (N, Lq, H, L, P, 2) and softmaxed weights
                              (N, Lq, H, L, P), after point-top-m, under
                              'sampling_locations' and 'sampling_weights'
                              (tuples, one entry per call, as JAX sows
                              them).
        Returns:
            (N, Lq, C) attended features, and the escaped attention mass of
            the windowed sampler (a float32 scalar; None without a plan).
        """
        with span("mvg.projattn"):
            N, Lq, C = query.shape
            H, P = self.n_heads, self.n_points

            # the per-level reference-point feature: grid_sample
            # (align_corners=False) on the grid clamp(2r - 1, -1.1, 1.1)
            ref_feats = []
            for lvl, (h, w) in enumerate(spatial_shapes):
                g = torch.clamp(reference_points[:, :, lvl, :] * 2.0 - 1.0,
                                -1.1, 1.1)
                x = (g[..., 0] + 1.0) * 0.5 * w - 0.5
                y = (g[..., 1] + 1.0) * 0.5 * h - 0.5
                v = src_views[lvl].reshape(N, h * w, C)
                ref_feats.append(bilinear_sample(v, x, y, h, w))
            ref_feats = torch.stack(ref_feats, dim=2)  # (N, Lq, L, C)

            input_flatten = torch.cat([s.reshape(N, -1, C) for s in src_views],
                                      dim=1)
            if self.pos_channels:
                want = tuple(input_flatten.shape[:2]) + (self.pos_channels,)
                got = (None if camera_ray_embeds is None
                       else tuple(camera_ray_embeds.shape))
                if got != want:
                    raise ValueError(f"this ProjAttn takes camera_ray_embeds "
                                     f"of shape {want}, got {got}")
                input_flatten = torch.cat(
                    [input_flatten, camera_ray_embeds.to(input_flatten.dtype)],
                    dim=-1)
            elif camera_ray_embeds is not None:
                raise ValueError("camera_ray_embeds given to a ProjAttn in "
                                 "mode 'ablation_not_use_rayconv'")
            value = self.rayconv(input_flatten)
            Len_in = value.shape[1]
            value = value.reshape(N, Len_in, H, self.d_model // H)

            mix = (ref_feats + query[:, :, None, :]).to(self.dtype)
            offsets = self.sampling_offsets(mix)   # (N, Lq, L, H*n_levels*P*2)
            weights = self.attention_weights(mix)  # (N, Lq, L, H*n_levels*P)

            # row-major reinterpretation across the stacked level axis
            Lt = len(src_views) * self.n_levels
            offsets = offsets.reshape(N, Lq, H, Lt, P, 2)
            if offset_clamp_px is not None:
                # in each level's own pixel units, before the division by
                # (w, h)
                offsets = torch.clamp(offsets, -float(offset_clamp_px),
                                      float(offset_clamp_px))
            weights = F.softmax(weights.reshape(N, Lq, H, Lt * P), dim=-1)
            weights = weights.reshape(N, Lq, H, Lt, P)

            normalizer = constant([[w, h] for h, w in spatial_shapes],
                                  device=query.device)
            locations = (reference_points[:, :, None, :, None, :]
                         + offsets / normalizer[None, None, None, :, None, :])

            if point_topm is not None and point_topm < P:
                # keep the top-m points per (query, head, level) and
                # renormalize over (level, point) so the mass stays 1
                with span("mvg.point_topm"):
                    weights, locations = select_point_topm(
                        weights, locations, int(point_topm))

            if taps is not None:
                for key, val in (("sampling_locations", locations),
                                 ("sampling_weights", weights)):
                    taps[key] = taps.get(key, ()) + (val.detach(),)

            escaped = None
            if train:
                if window_plan is not None:
                    raise ValueError("the window plan is for serving only")
                out = deform_sample_corner(value, spatial_shapes,
                                           locations.float(),
                                           weights.to(value.dtype))
            elif window_plan is not None:
                # the windowed sampler takes float32 weights, the gather takes
                # them in the value dtype
                out, escaped = window_sample(value, spatial_shapes,
                                             locations.float(),
                                             weights.float(), window_plan)
            else:
                out = deform_sample(value.contiguous(), spatial_shapes,
                                    locations.float().contiguous(),
                                    weights.to(value.dtype).contiguous())
            return self.output_proj(out), escaped
