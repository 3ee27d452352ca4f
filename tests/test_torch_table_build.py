"""The port's corner-table build (ops/table_build.py, the plain version of
kernel B2 on the CPU) against JAX's Pallas build
(mvgformer_tpu/ops/table_pallas.py, interpret mode off the TPU):

  * the tables bit for bit in float32 and bfloat16 at the shapes of
    tests/test_table_pallas.py, including the zero columns past w + 1;
  * the backward (four shifted slice-adds) bit for bit against JAX's
    custom VJP for the same cotangent: the same additions in the same
    order, in float32;
  * every level of a (N, Len_in, H, D) value through build_corner_tables,
    the strided level views the sampler hands the kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvgformer_tpu.ops import table_pallas as jtp
from mvgformer_tpu_torch.ops import table_build

SHAPES = ((8, 12), (4, 6))


@pytest.mark.parametrize("h,w", SHAPES + ((3, 14), (1, 1)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_level_table_equals_jax(rng, h, w, dtype):
    v = rng.randn(3, h, w, 8).astype(np.float32)
    want = np.asarray(jtp.build_corner_table_level(
        jnp.asarray(v).astype(dtype), h, w).astype(jnp.float32))
    got = table_build.build_corner_table_level(
        torch.from_numpy(v).to(getattr(torch, dtype)), h, w)
    assert got.dtype == getattr(torch, dtype)
    assert table_build.padded_width(w) == jtp.padded_width(w)
    assert got.shape == want.shape == (3, (h + 2) * jtp.padded_width(w), 32)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("h,w", SHAPES)
def test_backward_equals_jax_vjp(rng, h, w):
    v = rng.randn(3, h, w, 8).astype(np.float32)
    ct = rng.randn(3, (h + 2) * jtp.padded_width(w), 32).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jtp.build_corner_table_level(x, h, w),
                     jnp.asarray(v))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    tv = torch.from_numpy(v).requires_grad_(True)
    table_build.build_corner_table_level(tv, h, w).backward(
        torch.from_numpy(ct))
    np.testing.assert_array_equal(tv.grad.numpy(), want)


def test_all_levels_of_the_value(rng):
    """build_corner_tables from strided level views of the transposed
    value equals JAX's build_corner_tables_pallas; so do the strides."""
    N, H, D = 2, 3, 8
    value = rng.randn(N, sum(h * w for h, w in SHAPES), H, D).astype(
        np.float32)
    want, want_strides = jtp.build_corner_tables_pallas(
        jnp.swapaxes(jnp.asarray(value), 1, 2), SHAPES)
    got, strides = table_build.build_corner_tables(
        torch.from_numpy(value).transpose(1, 2), SHAPES)
    assert strides == list(want_strides)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
