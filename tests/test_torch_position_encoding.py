"""The port's positional encodings (models/position_encoding.py) against
the JAX package's on the same inputs:

  * position_embedding_sine at two sizes and both normalizations: float32
    atol 1e-5 (sines of arguments up to 2 pi);
  * crop_intrinsics on the cameras and crops of a synthetic batch: rtol
    1e-6 (a 3 x 3 product of entries up to ~1e3);
  * get_rays at three feature-map sizes: atol 2e-3 (a unit ray is the
    difference of world points ~1e4 mm from the origin, so float32
    cancellation leaves ~1e-3 in either package), every ray of unit norm;
  * get_2d_coords: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvgformer_tpu.config import load_config as jax_load_config
from mvgformer_tpu.data.synthetic import make_batch as jax_make_batch
from mvgformer_tpu.geometry.cameras import calib_matrix as jcalib
from mvgformer_tpu.models import position_encoding as jpe
from mvgformer_tpu_torch.data.synthetic import batch_from_jax
from mvgformer_tpu_torch.geometry.cameras import calib_matrix
from mvgformer_tpu_torch.models import position_encoding as pe


@pytest.fixture(scope="module")
def rig():
    cfg = jax_load_config()
    cfg.DATASET.CAMERA_NUM = 3
    jb = jax_make_batch(cfg, batch_size=2, seed=5, num_people=1)
    return cfg, jb, batch_from_jax(jb)


@pytest.mark.parametrize("h,w,normalize", [(8, 12, True), (5, 7, False)])
def test_position_embedding_sine(h, w, normalize):
    want = np.asarray(jpe.position_embedding_sine(h, w, 16,
                                                  normalize=normalize))
    got = pe.position_embedding_sine(h, w, 16, normalize=normalize).numpy()
    assert got.shape == (h, w, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _crop_intrinsics(jb, b):
    jK = jpe.crop_intrinsics(jcalib(jb.view_data.cameras),
                             jb.view_data.affine)
    K = pe.crop_intrinsics(calib_matrix(b.view_data.cameras),
                           b.view_data.affine)
    return jK, K


def test_crop_intrinsics(rig):
    _, jb, b = rig
    jK, K = _crop_intrinsics(jb, b)
    assert K.shape == (2, 3, 3, 3)
    np.testing.assert_allclose(K.numpy(), np.asarray(jK), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("h,w", [(32, 60), (16, 30), (8, 15)])
def test_get_rays(rig, h, w):
    cfg, jb, b = rig
    jK, K = _crop_intrinsics(jb, b)
    jcams, cams = jb.view_data.cameras, b.view_data.cameras
    want = np.asarray(jpe.get_rays(tuple(cfg.NETWORK.IMAGE_SIZE), h, w, jK,
                                   jcams.R, -jnp.matmul(jcams.R, jcams.T)))
    got = pe.get_rays(tuple(cfg.NETWORK.IMAGE_SIZE), h, w, K, cams.R,
                      -(cams.R @ cams.T))
    assert got.shape == (2, 3, h, w, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(torch.linalg.norm(got, dim=-1).numpy(), 1.0,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)


@pytest.mark.parametrize("h,w", [(4, 6), (7, 3)])
def test_get_2d_coords(h, w):
    np.testing.assert_array_equal(pe.get_2d_coords(h, w).numpy(),
                                  np.asarray(jpe.get_2d_coords(h, w)))
