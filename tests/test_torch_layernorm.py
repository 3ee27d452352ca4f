"""The port's LayerNorm (models/decoder.py) against flax's nn.LayerNorm at
the compute dtypes the configs set.

flax computes a LayerNorm's statistics, scale and bias in float32 with the
float32 parameters and casts the result to its dtype; its scale and bias
gradients are float32 sums over the rows. torch's own bfloat16 layer_norm
on the CPU sums those gradients over the rows in bfloat16: at 15,360 rows
(one flagship frame's queries x joints) its bias gradient was 4.8% and
its scale gradient 6.4% of their largest off a float64 sum, and the
port's bfloat16 training gradients of every LayerNorm moved by up to 10%
of their largest between a 2-frame step and two 1-frame steps (JAX's
2.3%). Here: the forward equals flax's to one bfloat16 rounding, and the
gradients are within 1e-3 of their largest against flax's and against a
float64 sum of the same cotangents.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvgformer_tpu_torch.models.decoder import LayerNorm

ROWS, WIDTH = 15360, 64


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.normal(0.0, 2.0, (ROWS, WIDTH)).astype(np.float32)
    ct = rng.normal(0.0, 1.0, (ROWS, WIDTH)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=WIDTH)).astype(np.float32)
    bias = (0.1 * rng.normal(size=WIDTH)).astype(np.float32)
    return x, ct, scale, bias


def _flax(x, ct, scale, bias, dtype):
    ln = fnn.LayerNorm(dtype=dtype)
    params = {"params": {"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}}
    xin = jnp.asarray(x).astype(dtype)
    y, vjp = jax.vjp(lambda p: ln.apply(p, xin), params)
    (g,) = vjp(jnp.asarray(ct).astype(dtype))
    return (np.asarray(y.astype(jnp.float32)),
            np.asarray(g["params"]["scale"]), np.asarray(g["params"]["bias"]))


def _port(x, ct, scale, bias, dtype):
    ln = LayerNorm(WIDTH, dtype)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
    y = ln(torch.from_numpy(x).to(dtype))
    y.backward(torch.from_numpy(ct).to(dtype))
    return (y.detach().float().numpy(), ln.weight.grad.numpy(),
            ln.bias.grad.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_flax(dtype):
    x, ct, scale, bias = _inputs()
    want_y, want_scale, want_bias = _flax(x, ct, scale, bias,
                                          getattr(jnp, dtype))
    y, g_scale, g_bias = _port(x, ct, scale, bias, getattr(torch, dtype))
    # one rounding to the output dtype apart
    ulp = 2.0 ** -7 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(y, want_y, rtol=ulp, atol=1e-5)
    for got, want in ((g_scale, want_scale), (g_bias, want_bias)):
        assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


def test_bfloat16_parameter_gradients_are_float32_sums():
    """The scale and bias gradients against float64 sums of the same
    bfloat16 cotangents over the rows."""
    x, ct, scale, bias = _inputs(1)
    _, g_scale, g_bias = _port(x, ct, scale, bias, torch.bfloat16)
    ct16 = torch.from_numpy(ct).bfloat16().double().numpy()
    xhat = torch.nn.functional.layer_norm(
        torch.from_numpy(x).bfloat16().double(), (WIDTH,),
        eps=1e-6).numpy()
    for got, want in ((g_bias, ct16.sum(0)),
                      (g_scale, (ct16 * xhat).sum(0))):
        assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()
