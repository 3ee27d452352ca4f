"""The port's datasets (mvgformer_tpu_torch/data/datasets.py), its native
warp (runtime/) and its synthetic scenes with rendered blobs, against the
JAX package's on the same files and seeds.

Panoptic, Shelf and H36M are built on disk by the fixtures of
tests/test_{panoptic,shelf,h36m}_files.py (imported, not edited); Campus
by a fixture here, in the Shelf fixture's layout. For each, the frames and
then `load_batch` and `batches` of both packages are compared:

  * cameras, targets (3D joints, 3D visibility, roots, people counts,
    VoxelPose predictions where attached), the per-view 2D visibility
    flags, centers and scales: equal;
  * the crop affines: JAX solves them in float32 (its float32 LU leaves
    up to ~1.5e-5 in an entry, 4.7e-9 where 0 is exact), the port in
    float64, so they are held at the class of
    tests/test_torch_model.py::test_make_batch_matches_jax (rtol 1e-5,
    atol 1e-4);
  * the views: the port's equal at atol 1e-6 to the JAX package's native
    warp given the port's affines, and to the JAX package's own views
    within what the affines' gap moves a bilinear sample of these images.

The native warp of both packages on the same images and affines is equal
bit for bit, and so is the cv2 fallback. Synthetic frames: random images
equal; rendered blobs (`render_blobs`, evaluated in a box around each
joint) at atol 1e-6 on the same joint pixels as JAX's full-image loop, and
the rendered batches within rtol 1e-5 / atol 1e-5 of JAX's (the affines'
gap again moves the blob centres; the largest difference measured is
1.4e-5 on blob sums of ~20).
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from mvgformer_tpu import runtime as jruntime
from mvgformer_tpu.data import datasets as jds
from mvgformer_tpu.data.synthetic import (make_batch as jax_make_batch,
                                          make_camera_ring, make_people)
from mvgformer_tpu_torch import runtime as truntime
from mvgformer_tpu_torch.data import datasets as tds
from mvgformer_tpu_torch.data.synthetic import make_batch, render_blobs

from test_h36m_files import _cfg_for as h36m_cfg, h36m_root  # noqa: F401
from test_model import small_cfg
from test_panoptic_files import (ANNO_SEQ, N_PEOPLE,  # noqa: F401
                                 _cfg_for as panoptic_cfg, panoptic_root)
from test_shelf_files import (_cfg_for as shelf_cfg, _plain_calib,  # noqa: F401
                              shelf_root)
from torch_one_thread import one_torch_thread  # noqa: F401

CAMERA_FIELDS = ("R", "T", "f", "c", "k", "p")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_batch(got, want, views="jax_warp"):
    """got: the port's Batch; want: the JAX package's."""
    gv, wv = got.view_data, want.view_data
    for f in CAMERA_FIELDS:
        np.testing.assert_array_equal(_np(getattr(gv.cameras, f)),
                                      _np(getattr(wv.cameras, f)), err_msg=f)
    for f in ("centers", "scales", "joints_vis_2d"):
        np.testing.assert_array_equal(_np(getattr(gv, f)),
                                      _np(getattr(wv, f)), err_msg=f)
    for f in ("affine", "inv_affine"):
        np.testing.assert_allclose(_np(getattr(gv, f)), _np(getattr(wv, f)),
                                   rtol=1e-5, atol=1e-4, err_msg=f)
    gt, wt = got.targets, want.targets
    for f in ("joints_3d", "joints_3d_vis", "roots_3d", "num_person"):
        np.testing.assert_array_equal(_np(getattr(gt, f)),
                                      _np(getattr(wt, f)), err_msg=f)
    assert (gt.voxelpose_pred is None) == (wt.voxelpose_pred is None)
    if wt.voxelpose_pred is not None:
        np.testing.assert_array_equal(_np(gt.voxelpose_pred),
                                      _np(wt.voxelpose_pred))
    assert got.views.dtype == torch.float32
    assert tuple(got.views.shape) == tuple(np.shape(want.views))
    if views == "equal":
        np.testing.assert_array_equal(got.views.numpy(), _np(want.views))


def _assert_views_warped(ds, indices, got, want):
    """The port's views against the JAX package's native warp of the same
    image files at the port's affines (atol 1e-6), and against the JAX
    package's views at atol 5e-4: the affines' gap moves a sample by
    ~1e-4 px, and these images hold edges of 128-200 grey levels (the
    largest difference measured is 1.8e-4)."""
    aff = got.view_data.affine.numpy()
    for b, i in enumerate(indices):
        frame = ds.frames[i]
        raw = np.stack([jds._load_image(p) for p in frame["images"]])
        ref = jruntime.warp_normalize_views(raw, aff[b], ds.net_size)
        np.testing.assert_allclose(got.views[b].numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(got.views.numpy(), _np(want.views),
                               atol=5e-4)
    assert float(got.views.abs().max()) > 0


def _assert_frames(got_ds, want_ds):
    assert len(got_ds) == len(want_ds)
    assert got_ds.num_views == want_ds.num_views
    for g, w in zip(got_ds.frames, want_ds.frames):
        for k in ("joints_3d", "joints_3d_vis", "joints_2d_vis"):
            if w.get(k) is None:
                assert g.get(k) is None
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert g["images"] == w["images"]


def test_panoptic_matches_jax(panoptic_root):
    root, people = panoptic_root
    cfg = panoptic_cfg(root)
    vp = np.zeros((N_PEOPLE, 15, 5), np.float32)
    vp[:, :, :3] = people
    vp[:, :, 4] = 0.5
    with open(root / "vp_preds_torch.pkl", "wb") as f:
        pickle.dump({"db": [{"key": f"{ANNO_SEQ}__00000000",
                             "joints_3d_voxelpose_pred": vp}]}, f)
    cfg.DATASET.ADD_VOXEL_PRED = str(root / "vp_preds_torch.pkl")
    want = jds.PanopticDataset(cfg, "validation", is_train=False)
    got = tds.PanopticDataset(cfg, "validation", is_train=False)
    _assert_frames(got, want)
    assert len(got) == 2
    # the port's own db pickle, beside the JAX package's
    assert any(p.startswith("mvgtorch_") for p in os.listdir(root))
    again = tds.PanopticDataset(cfg, "validation", is_train=False)
    _assert_frames(again, want)
    b_got, b_want = got.load_batch([1, 0]), want.load_batch([1, 0])
    _assert_batch(b_got, b_want)
    _assert_views_warped(got, [1, 0], b_got, b_want)
    pred = np.zeros((N_PEOPLE, 15, 5), np.float32)
    pred[:, :, :3] = people
    pred[:, :, 4] = 0.95
    assert got.evaluate([pred, pred]) == want.evaluate([pred, pred])
    assert (got.observability_arrays(2)[2][0].shape
            == want.observability_arrays(2)[2][0].shape)


def test_shelf_matches_jax(shelf_root):
    root, people_mm, _ = shelf_root
    cfg = shelf_cfg(root)
    want = jds.ShelfDataset(cfg, "validation", is_train=False)
    got = tds.ShelfDataset(cfg, "validation", is_train=False)
    _assert_frames(got, want)
    b_got, b_want = got.load_batch([0, 1]), want.load_batch([0, 1])
    _assert_batch(b_got, b_want)
    _assert_views_warped(got, [0, 1], b_got, b_want)
    pred = np.zeros((3, 14, 5), np.float32)
    pred[:, :, :3] = people_mm
    pred[:, :, 4] = 0.95
    g, w = got.evaluate([pred, pred]), want.evaluate([pred, pred])
    np.testing.assert_array_equal(g[0], w[0])
    assert g[1] == w[1] and g[3] == w[3]


def test_shelf_finetune_frames_match_jax(shelf_root):
    root, _, people15 = shelf_root
    cfg = shelf_cfg(root)
    cfg.DATASET.PESUDO_GT = "shelf_pgt_torch.pkl"
    (root / "pesudo_gt").mkdir(exist_ok=True)
    with open(root / "pesudo_gt" / "shelf_pgt_torch.pkl", "wb") as f:
        pickle.dump({"img_000000.png": list(people15),
                     "img_000005.png": [people15[0]]}, f)
    want = jds.ShelfDataset(cfg, "train", is_train=True)
    got = tds.ShelfDataset(cfg, "train", is_train=True)
    _assert_frames(got, want)
    idx = [0, 5, 7]
    pos = [i for i, f in enumerate(want.frames) if f["frame_index"] in idx]
    _assert_batch(got.load_batch(pos, load_images=False),
                  want.load_batch(pos, load_images=False), views="equal")


@pytest.fixture(scope="module")
def campus_root(tmp_path_factory):
    """A byte-level Campus tree in the Shelf fixture's layout: 3 cameras at
    360 x 288, actorsGT.mat in meters (actor 1 absent in frame 351) and
    images for frames 350 and 351."""
    import cv2
    import scipy.io as scio

    root = tmp_path_factory.mktemp("campus")
    cams = make_camera_ring(3, image_size=(360, 288))
    with open(root / "calibration_campus.json", "w") as f:
        json.dump(_plain_calib(cams, 3), f)
    people = make_people(3, seed=6)[:, :14] / 1000.0
    n_frames = 752
    actor3d = np.empty((1, 3), object)
    for a in range(3):
        cells = np.empty((n_frames, 1), object)
        for fi in range(n_frames):
            cells[fi, 0] = (np.zeros((1, 0)) if a == 1 and fi == 351
                            else people[a].astype(np.float64))
        actor3d[0, a] = cells
    scio.savemat(root / "actorsGT.mat", {"actor3D": actor3d})
    img = np.zeros((288, 360, 3), np.uint8)
    img[:, ::16] = 200
    for v in range(3):
        (root / f"Camera{v}").mkdir()
        for fi in (350, 351):
            cv2.imwrite(str(root / f"Camera{v}"
                            / f"campus4-c{v}-{fi:05d}.png"), img)
    return root, people * 1000.0


def test_campus_matches_jax(campus_root):
    root, people_mm = campus_root
    cfg = small_cfg()
    cfg.DATA_DIR = str(root)
    cfg.DATASET.ROOT = ""
    cfg.DATASET.TEST_DATASET = "campus"
    want = jds.get_dataset(cfg, "validation", is_train=False)
    got = tds.get_dataset(cfg, "validation", is_train=False)
    assert isinstance(got, tds.CampusDataset)
    _assert_frames(got, want)
    assert got.frames[1]["joints_3d"].shape[0] == 2
    b_got, b_want = got.load_batch([0, 1]), want.load_batch([0, 1])
    _assert_batch(b_got, b_want)
    _assert_views_warped(got, [0, 1], b_got, b_want)
    pred = np.zeros((3, 14, 5), np.float32)
    pred[:, :, :3] = people_mm
    pred[:, :, 4] = 0.95
    g, w = got.evaluate([pred] * 3), want.evaluate([pred] * 3)
    np.testing.assert_array_equal(g[0], w[0])
    assert g[1] == w[1] and g[3] == w[3]


def test_h36m_matches_jax(h36m_root):
    root, _ = h36m_root
    cfg = h36m_cfg(root)
    want = jds.H36MDataset(cfg, "validation", is_train=False)
    got = tds.H36MDataset(cfg, "validation", is_train=False)
    _assert_frames(got, want)
    for g, w in zip(got.frames, want.frames):
        for f in CAMERA_FIELDS:
            np.testing.assert_array_equal(_np(getattr(g["cameras"], f)),
                                          _np(getattr(w["cameras"], f)))
    _assert_batch(got.load_batch([0, 1], load_images=False),
                  want.load_batch([0, 1], load_images=False),
                  views="equal")


@pytest.mark.parametrize("render", [False, True])
def test_synthetic_batches_match_jax(render):
    cfg = small_cfg()
    cfg.DATASET.MAX_DATA_NUM = 5
    want = jds.SyntheticDataset(cfg, "validation", is_train=False)
    got = tds.SyntheticDataset(cfg, "validation", is_train=False)
    assert len(got) == len(want) == 5
    n = 0
    for (gi, gb), (wi, wb) in zip(
            got.batches(2, shuffle=False, load_images=render,
                        drop_last=False),
            want.batches(2, shuffle=False, load_images=render,
                         drop_last=False)):
        assert gi == wi
        _assert_batch(gb, wb, views="rendered" if render else "equal")
        if render:
            np.testing.assert_allclose(gb.views.numpy(), _np(wb.views),
                                       rtol=1e-5, atol=1e-5)
        n += 1
    assert n == 3 and gi == [4, 4]  # the last batch repeats its last frame
    g_order = [i for i, _ in got.batches(2, shuffle=True, seed=3,
                                         load_images=False)]
    w_order = [i for i, _ in want.batches(2, shuffle=True, seed=3,
                                          load_images=False)]
    assert g_order == w_order
    pred = np.zeros((4, 15, 5), np.float32)
    assert got.evaluate([pred] * 5) == want.evaluate([pred] * 5)
    ga, wa = got.observability_arrays(3), want.observability_arrays(3)
    for g, w in zip(ga, wa):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y)


def test_render_blobs_match_jax_on_the_same_pixels():
    """JAX's full-image loop against the port's boxed blobs, on JAX's own
    joint pixels: atol 1e-6 (the terms beyond the box round to 0 in
    float32), at the ablation config's 480 x 256 views."""
    import jax.numpy as jnp

    from mvgformer_tpu.geometry.cameras import project_points
    from mvgformer_tpu.geometry.transforms import apply_affine

    cfg = small_cfg()
    cfg.NETWORK.IMAGE_SIZE = [480, 256]
    cfg.DATASET.CAMERA_NUM = 5
    jb = jax_make_batch(cfg, batch_size=1, seed=4, num_people=3,
                        render=True, cam_seed=0)
    W, H = cfg.NETWORK.IMAGE_SIZE
    M, J, V = 4, 15, 5
    gt = np.asarray(jb.targets.joints_3d)
    flat = np.broadcast_to(gt.reshape(1, 1, M * J, 3), (1, V, M * J, 3))
    pix = np.asarray(project_points(jnp.asarray(flat), jb.view_data.cameras))
    net_pix = np.asarray(apply_affine(jnp.asarray(pix), jb.view_data.affine)
                         ).reshape(1, V, M, J, 2)
    vis2d = np.asarray(jb.view_data.joints_vis_2d)
    got = render_blobs(net_pix, vis2d, 3, H, W)
    want = np.asarray(jb.views)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert want.max() > 1.0


def test_native_warp_matches_jax(rng):
    V, sh, sw = 3, 120, 200
    images = rng.randint(0, 255, (V, sh, sw, 3)).astype(np.uint8)
    aff = np.stack([np.array([[0.48 + 0.01 * v, 0.02, -3.0 + v],
                              [-0.01, 0.5, 2.5]], np.float32)
                    for v in range(V)])
    assert truntime.native_available()
    got = truntime.warp_normalize_views(images, aff, (96, 64))
    want = jruntime.warp_normalize_views(images, aff, (96, 64))
    np.testing.assert_array_equal(got, want)
    assert str(truntime.library_path()).endswith(".so")
    assert "build" in truntime.library_path().parts
    cv2_got = truntime.warp_normalize_cv2(images[0], aff[0], (96, 64))
    cv2_want = jds._warp_normalize_cv2(images[0], aff[0], (96, 64))
    np.testing.assert_array_equal(cv2_got, cv2_want)
