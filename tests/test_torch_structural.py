"""The port's structural triangulation (geometry/structural.py) against the
JAX package's, on tests/test_structural.py's setups (a 5-view ring, CMU
Panoptic poses projected without distortion):

  * the kinematic tree's conversion matrices equal JAX's (exactly: both are
    the same float64 construction), for every tree, and the T-pose's bone
    lengths;
  * methods LS, ST (1 and 3 SCA steps) and Lagrangian with 2D noise of 15
    px and random confidences: 3D p99 < 2 mm and max < 6 mm against JAX,
    both in float32;
  * the noiseless least-squares solve recovers the poses (rtol 1e-3, atol
    5 mm, as the JAX package's test holds its own);
  * 'ST' without bone lengths raises.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mvgformer_tpu.geometry import structural as jst
from mvgformer_tpu.models.mvgformer import (_tpose_bone_lengths,
                                            load_tpose as jload_tpose)
from mvgformer_tpu_torch.geometry import structural as st
from mvgformer_tpu_torch.models.mvgformer import (load_tpose,
                                                  tpose_bone_lengths)
from test_structural import _setup


@pytest.mark.parametrize("tree", list(st.TREES))
def test_conversion_matrices_equal(tree):
    ours, theirs = st.HumanTree(tree), jst.HumanTree(tree)
    assert st.TREES[tree] == jst.TREES[tree]
    np.testing.assert_array_equal(ours.conv_J2B, theirs.conv_J2B)
    np.testing.assert_array_equal(ours.conv_B2J, theirs.conv_B2J)


def test_tpose_bone_lengths_equal():
    np.testing.assert_array_equal(tpose_bone_lengths(load_tpose()),
                                  _tpose_bone_lengths(jload_tpose()))


@pytest.mark.parametrize("method,steps", [("LS", 1), ("ST", 1), ("ST", 3),
                                          ("Lagrangian", 3)])
def test_methods_match_jax(method, steps):
    _, pix, proj, lengths = _setup(B=4, noise=15.0, seed=3)
    conf = np.random.RandomState(0).uniform(
        0.1, 1.0, pix.shape[:3]).astype(np.float32)
    lengths = lengths.astype(np.float32)
    want = np.asarray(jst.structural_triangulate(
        jnp.asarray(proj), jnp.asarray(pix), jnp.asarray(conf),
        jnp.asarray(lengths), n_steps=steps, method=method))
    got = st.structural_triangulate(
        torch.tensor(proj), torch.tensor(pix),
        torch.tensor(conf), torch.tensor(lengths), n_steps=steps,
        method=method)
    assert got.shape == (4, 15, 3) and got.dtype == torch.float32
    err = np.abs(got.numpy() - want)
    assert np.percentile(err, 99) < 2.0 and err.max() < 6.0, err.max()


def test_exact_recovery_noiseless():
    people, pix, proj, lengths = _setup(noise=0.0)
    out = st.structural_triangulate(
        torch.tensor(proj), torch.tensor(pix), None,
        torch.tensor(lengths.astype(np.float32)), n_steps=1,
        method="LS").numpy()
    np.testing.assert_allclose(out, people, rtol=1e-3, atol=5.0)


def test_st_needs_bone_lengths():
    _, pix, proj, _ = _setup(noise=0.0)
    with pytest.raises(ValueError, match="bone_lengths"):
        st.structural_triangulate(torch.tensor(proj),
                                  torch.tensor(pix))


@pytest.mark.parametrize("method", ["st", "ls", "SCA"])
def test_unknown_method_raises(method):
    """The methods are 'LS', 'ST' and 'Lagrangian', case and all."""
    _, pix, proj, lengths = _setup(noise=0.0)
    with pytest.raises(ValueError, match="unknown structural method"):
        st.structural_triangulate(
            torch.tensor(proj), torch.tensor(pix), None,
            torch.tensor(lengths.astype(np.float32)), method=method)


def test_prebuilt_conversion_gives_the_same_bits():
    """A caller's conversion matrix (the decoder layer builds it once)
    solves exactly as the one built per call."""
    _, pix, proj, lengths = _setup(B=3, noise=15.0, seed=5)
    args = (torch.tensor(proj), torch.tensor(pix), None,
            torch.tensor(lengths.astype(np.float32)))
    conv = torch.tensor(st.HumanTree().conv_B2J, dtype=torch.float32)
    torch.testing.assert_close(
        st.structural_triangulate(*args, conversion=conv),
        st.structural_triangulate(*args), rtol=0, atol=0)
