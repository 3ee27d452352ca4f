"""Parity of the port's geometry (mvgformer_tpu_torch.geometry) with the JAX
package on the same float32 inputs.

Tolerance: rtol 1e-5 / atol 1e-4, float32 rounding of pixel- and mm-scale
values computed in a different operation order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mvgformer_tpu.data.synthetic import make_camera_ring
from mvgformer_tpu.geometry import cameras as jcam
from mvgformer_tpu.geometry import transforms as jtf
from mvgformer_tpu.geometry import triangulate as jtri
from mvgformer_tpu_torch.geometry import cameras as tcam
from mvgformer_tpu_torch.geometry import transforms as ttf
from mvgformer_tpu_torch.geometry import triangulate as ttri

RTOL, ATOL = 1e-5, 1e-4


def _cams(V=4, seed=3):
    """The same (V, ...) camera ring for both packages."""
    ring = make_camera_ring(V, seed=seed)
    jc = jcam.CameraParams(**{k: jnp.asarray(getattr(ring, k))
                              for k in ("R", "T", "f", "c", "k", "p")})
    tc = tcam.CameraParams(**{k: torch.from_numpy(np.asarray(getattr(ring, k)))
                              for k in ("R", "T", "f", "c", "k", "p")})
    return jc, tc


def _points(rng, V, n=50):
    """World points around the capture-space centre, shaped (V, n, 3)."""
    pts = rng.uniform(-1500, 1500, size=(n, 3)).astype(np.float32)
    pts += np.array([0.0, -500.0, 800.0], np.float32)
    return np.broadcast_to(pts, (V, n, 3)).copy()


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("distort", [True, False])
def test_project_points(rng, distort):
    jc, tc = _cams()
    x = _points(rng, 4)
    _close(jcam.world_to_camera(jnp.asarray(x), jc),
           tcam.world_to_camera(torch.from_numpy(x), tc))
    _close(jcam.project_points(jnp.asarray(x), jc, deal_distortion=distort),
           tcam.project_points(torch.from_numpy(x), tc,
                               deal_distortion=distort))


def test_distort_keeps_reference_quirk(rng):
    jc, tc = _cams()
    y = rng.uniform(-0.6, 0.6, size=(4, 20, 2)).astype(np.float32)
    _close(jcam._distort(jnp.asarray(y), jc),
           tcam._distort(torch.from_numpy(y), tc), atol=1e-6)


def test_calib_and_projection_matrices():
    jc, tc = _cams()
    _close(jcam.calib_matrix(jc), tcam.calib_matrix(tc))
    _close(jcam.projection_matrices(jc), tcam.projection_matrices(tc),
           rtol=1e-5, atol=1e-2)


def test_undistort_points(rng):
    jc, tc = _cams()
    pix = rng.uniform(0, 1900, size=(4, 30, 2)).astype(np.float32)
    _close(jcam.undistort_points(jnp.asarray(pix), jc, iter_num=5),
           tcam.undistort_points(torch.from_numpy(pix), tc, iter_num=5))


def test_affine_transforms(rng):
    image_wh = np.array([[1920.0, 1080.0], [1280.0, 1024.0]], np.float32)
    centers = image_wh / 2.0
    scales = np.stack([ttf.get_scale(wh, (960, 512)) for wh in image_wh])
    np.testing.assert_array_equal(
        scales, np.stack([jtf.get_scale(wh, (960, 512)) for wh in image_wh]))
    for jfn, tfn in ((jtf.get_affine_transform, ttf.get_affine_transform),
                     (jtf.get_affine_transform_inv,
                      ttf.get_affine_transform_inv)):
        ja = jfn(jnp.asarray(centers), jnp.asarray(scales), (960, 512))
        ta = tfn(centers, scales, (960, 512))
        _close(ja, ta)
        pts = rng.uniform(0, 1000, size=(2, 7, 2)).astype(np.float32)
        _close(jtf.apply_affine(jnp.asarray(pts), ja),
               ttf.apply_affine(torch.from_numpy(pts), ta))


def _dlt_problem(rng, n=40, noise=0.5):
    """Projection matrices, noisy undistorted observations and per-view
    confidences of n points seen by a 5-camera ring; (n, V, ...)."""
    jc, _ = _cams(V=5, seed=1)
    P = np.asarray(jcam.projection_matrices(jc))  # (V, 3, 4)
    x = _points(rng, 5, n)
    pix = np.asarray(jcam.project_points(jnp.asarray(x), jc,
                                         deal_distortion=False))
    pix = pix + rng.normal(0, noise, size=pix.shape).astype(np.float32)
    pts = np.transpose(pix, (1, 0, 2)).copy()  # (n, V, 2)
    conf = rng.uniform(0.05, 1.0, size=(n, 5)).astype(np.float32)
    conf /= conf.sum(-1, keepdims=True)
    pm = np.broadcast_to(P, (n,) + P.shape).copy()
    return pm, pts, conf, x[0]


@pytest.mark.parametrize("solver", ["svd", "eigh", "jacobi"])
def test_triangulate_dlt(rng, solver):
    pm, pts, conf, truth = _dlt_problem(rng)
    got_j = np.asarray(jtri.triangulate_dlt(
        jnp.asarray(pm), jnp.asarray(pts), jnp.asarray(conf), solver=solver))
    got_t = ttri.triangulate_dlt(torch.from_numpy(pm), torch.from_numpy(pts),
                                 torch.from_numpy(conf),
                                 solver=solver).numpy()
    # the exact DLT solution of the same system, float64 throughout
    A = ttri._dlt_system(torch.from_numpy(pm).double(),
                         torch.from_numpy(pts).double(),
                         torch.from_numpy(conf).double())
    exact = ttri.homogeneous_to_euclidean(
        -torch.linalg.svd(A)[2][..., 3, :]).numpy()
    assert np.abs(got_t - truth).max() < 5.0  # within the pixel noise
    # float32 precision of mm coordinates at 1-3 m
    np.testing.assert_allclose(got_t, exact, rtol=0, atol=2e-2)
    if solver == "svd":
        # JAX's float32 SVD of the un-equilibrated A (entries 1..1e7) is
        # itself ~0.4 mm from exact here; the port's differs from it by
        # no more than that
        assert np.all(np.abs(got_t - got_j)
                      <= np.abs(got_j - exact) + 2e-2)
    else:
        np.testing.assert_allclose(got_j, got_t, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("solver", ["svd", "eigh", "jacobi"])
def test_triangulate_degenerate_guard(rng, solver):
    """All-zero confidences give A == 0; both packages return the origin."""
    pm, pts, conf, _ = _dlt_problem(rng, n=6)
    conf[:3] = 0.0
    got_j = np.asarray(jtri.triangulate_dlt(
        jnp.asarray(pm), jnp.asarray(pts), jnp.asarray(conf), solver=solver))
    got_t = ttri.triangulate_dlt(torch.from_numpy(pm), torch.from_numpy(pts),
                                 torch.from_numpy(conf), solver=solver)
    np.testing.assert_allclose(got_t.numpy()[:3], 0.0, atol=1e-6)
    np.testing.assert_allclose(got_j[:3], got_t.numpy()[:3], atol=1e-6)
    assert np.isfinite(got_t.numpy()).all()


def test_jacobi4_smallest(rng):
    """Unit null-ish vectors of random symmetric PSD 4x4 matrices agree
    with JAX up to sign and with torch.linalg.eigh."""
    M = rng.randn(64, 6, 4).astype(np.float32)
    G = np.einsum("bij,bik->bjk", M, M)
    vj = np.asarray(jtri.jacobi4_smallest(jnp.asarray(G)))
    vt = ttri.jacobi4_smallest(torch.from_numpy(G)).numpy()
    ve = torch.linalg.eigh(torch.from_numpy(G).double())[1][..., 0].numpy()
    for ref in (vj, ve):
        sign = np.sign(np.sum(ref * vt, axis=-1, keepdims=True))
        np.testing.assert_allclose(vt * sign, ref, rtol=1e-4, atol=1e-4)


def test_homogeneous_to_euclidean(rng):
    x = rng.randn(5, 4).astype(np.float32) + 3.0
    _close(jtri.homogeneous_to_euclidean(jnp.asarray(x)),
           ttri.homogeneous_to_euclidean(torch.from_numpy(x)))
