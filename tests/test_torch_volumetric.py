"""The volumetric Learnable Triangulation model on the port's serving path
(`models/volumetric.py`, `models/v2v.py::V2VModel`,
`core/infer.py::make_eval_step`) against the plain reference of the
benchmark (`benchmark/reference/volumetric_triangulation.py`, which
imports nothing of the port), at toy sizes on the CPU: PoseResNet-18 with
32 deconvolution filters, 64x64 images, 3 views, a 32^3 cube (the five
pools need a multiple of 32) and 4 processed channels, on weights drawn
from a seed by name and shape (`benchmark/weights.py`) and the
benchmark's synthetic frames of one subject.

  * the served pred against the reference's, joint for joint;
  * the five-level V2V alone against the reference's;
  * the unprojection and the softmax over views against a loop over
    points and views: points inside an image, outside every image, and
    behind a camera, where the projection lands on the image's centre;
  * the pelvis stage against the reference's DLT of the same heatmaps
    (the column-scaled system), and on heatmaps drawn at the subject's
    pelvis against the subject; the gap to the paper's unscaled SVD is
    recorded (junit property `unscaled_svd_gap_mm`), not asserted;
  * MVGFormer's, MvP's and VoxelPose's state dicts (names, shapes, order)
    as they were, so the weights the benchmark draws for them are too;
  * the new spans and counter in a profiled step, and the refusals.

On the card (`-m gpu`; this file imports no JAX, so `--noconftest` runs
it there): a served step makes no host synchronization and triangulates
the pelvis with the DLT kernel.
"""

import copy
import hashlib
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import frames, program, weights
from benchmark.reference import geometry as G
from benchmark.reference import model as ref_model
from benchmark.reference import volumetric_triangulation as ref_lt
from mvgformer_tpu_torch.models.v2v import V2VModel
from mvgformer_tpu_torch.models.volumetric import (VIEW_VOLUMES, cube_axes,
                                                   unproject)
from mvgformer_tpu_torch.models.voxelpose import grid_of
from mvgformer_tpu_torch.ops.dlt_jacobi import fused_dlt
from mvgformer_tpu_torch.utils import profiling
from torch_one_thread import one_torch_thread  # noqa: F401

CHECKOUT = Path(__file__).resolve().parents[1]
TOY = {"NETWORK.IMAGE_SIZE": [64, 64], "NETWORK.HEATMAP_SIZE": [16, 16],
       "POSE_RESNET.NUM_LAYERS": 18,
       "POSE_RESNET.NUM_DECONV_FILTERS": [32, 32, 32],
       "DATASET.CAMERA_NUM": 3, "PICT_STRUCT.CUBE_SIZE": [32, 32, 32],
       "NETWORK.VOLUME_FEATURES": 4}
TRAFFIC = {"loop": "serve_closed", "batch": 1, "ring_frames": 3,
           "people": [1], "cam_seed": 0, "image_wh": [1000, 1000],
           "warmup_units": 1, "trace_units": 1, "check_units": 2}
CPU = torch.device("cpu")
J = 17
# Both sides are float32 on the CPU. They differ in the order of their
# sums (the port's batched sampling, folded BN and soft-argmax marginals
# against the reference's per-view loop, nn-free BN and one product over
# the voxels) and in the pelvis's solve (the port's float32 Jacobi sweeps
# against the reference's float64 SVD): joints read up to ~0.003 mm apart
# at coordinates of ~1000 mm, a few tens of float32 ulps there. A wrong
# step (a voxel off, a view's mask, the cube's spacing) moves a joint by
# millimetres.
POSE_ATOL_MM = 0.05
# the pelvis alone: the Jacobi sweeps against the SVD, the same system
PELVIS_ATOL_MM = 0.05
# heatmaps made so that their soft-argmax is the subject's pelvis: the
# point comes back through the inverse affine, 5 steps of undistortion
# and the DLT, each in float32
DRAWN_PELVIS_MM = 1.0
# the state dicts' (name, shape, dtype) lines, in order, at the
# benchmark's widths, as they were before this model
STATE_DIGESTS = {
    "mvgformer_panoptic5":
        "3d81ae36e85342ac29d0e6f5386082b231463840861bdda93490974e0ce3e4b2",
    "mvp_panoptic5":
        "97e4ed6dc554d19d5eab73afdfc2310bc1454c50ea6a6fe038ee2a6f72e50067",
    "voxelpose_panoptic5":
        "f48f20cec47b90d6a593538b9eebd81d136dbd5dc7473b7c8660f425a92f0ea2"}


def toy_spec(**settings) -> dict:
    spec = json.loads((CHECKOUT / "benchmark" / "configs"
                       / "ltvol_h36m4.json").read_text())
    spec["settings"].update(TOY, **settings)
    return spec


def served(spec: dict, seed: int, device=CPU):
    """The port's model on weights drawn from `seed`, its eval step at the
    spec's threshold, the drawn weights and the ring of frames."""
    cfg = program.config(spec)
    net = program.model(cfg, device)
    drawn = weights.draw(weights.float_shapes(net), seed, device)
    weights.load(net, drawn)
    ring = frames.make_ring(spec, TRAFFIC, seed, device)
    step = program.eval_step(cfg, net, spec["settings"][
        "MULTI_PERSON.THRESHOLD"])
    return net, step, drawn, ring


def frame_batch(ring, index: int):
    """The port's Batch of ring frame `index`, on the rig's device."""
    return program.batch(ring.views[index:index + 1].to(
        ring.rig["R"].device), ring.rig_batch(1), 1, J)


def heatmaps(net, batch):
    """The port's heatmaps (B, V, J, h, w) of a batch."""
    B, V = batch.views.shape[:2]
    with torch.no_grad():
        hm = net.backbone(batch.views.reshape((B * V,)
                                              + batch.views.shape[2:]))
    return hm.reshape((B, V) + hm.shape[1:])


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 3])
def test_served_pred_matches_the_plain_reference(seed):
    spec = toy_spec()
    _, step, drawn, ring = served(spec, seed)
    net = ref_model.Net(drawn)
    for i in range(len(ring)):
        got = step(frame_batch(ring, i))[0]
        want = ref_lt.frame(spec, net, ring.frame([i], CPU))["pred"][0]
        assert got.shape == want.shape == (1, J, 5)
        # one row of score 1.0, flagged valid at the default threshold
        assert torch.equal(got[..., 3:], want[..., 3:])
        assert torch.equal(got[..., 3:], torch.tensor([0.0, 1.0]).expand(
            1, J, 2))
        assert (got[..., :3] - want[..., :3]).abs().max() < POSE_ATOL_MM


def test_v2v_model_matches_the_reference():
    gen = torch.Generator().manual_seed(3)
    port = V2VModel(4, J, generator=gen).eval()
    drawn = weights.draw({"volume_net." + k: s for k, s in
                          weights.float_shapes(port).items()}, 7, CPU)
    weights.load(port, {k[len("volume_net."):]: v for k, v in drawn.items()})
    x = torch.rand((1, 4, 32, 32, 32), generator=gen)
    with torch.no_grad():
        got = port(x)
        want = ref_lt.v2v_model(ref_model.Net(drawn), "volume_net", x)
    assert got.shape == want.shape == (1, J, 32, 32, 32)
    # float32 in another order of sums (nn.BatchNorm3d against the folded
    # scale and shift): a few ulps of outputs of magnitude ~1
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def _unproject_loop(feats, rig, points, image_wh, mask_depth=True):
    """Per point, per view: project, crop to the network image of
    `image_wh`, scale to the maps, normalize
    as published (x by the height, y by the width, each by the size),
    bilinear corners by hand (align_corners, zero outside), zero behind
    the camera (unless not `mask_depth`); then the softmax over the views
    of every channel's entries and their sum."""
    V, C, h, w = feats.shape
    out = torch.zeros(C, len(points))
    for n, x in enumerate(points):
        per_view = torch.zeros(V, C)
        for v in range(V):
            cam = [rig[k][v] for k in "RTfckp"]
            depth = float((cam[0] @ (x - cam[1][:, 0]))[2])
            pix = G.project_points(x[None], *cam)
            u, t = G.apply_affine(pix, rig["affine"][v])[0].tolist()
            u, t = u * w / image_wh[0], t * h / image_wh[1]
            gx, gy = 2 * (u / h - 0.5), 2 * (t / w - 0.5)
            fx, fy = (gx + 1) / 2 * (w - 1), (gy + 1) / 2 * (h - 1)
            x0 = int(torch.floor(torch.tensor(fx)))
            y0 = int(torch.floor(torch.tensor(fy)))
            value = torch.zeros(C)
            for yy, xx in ((y0, x0), (y0, x0 + 1), (y0 + 1, x0),
                           (y0 + 1, x0 + 1)):
                wt = (1 - abs(fx - xx)) * (1 - abs(fy - yy))
                if 0 <= xx < w and 0 <= yy < h:
                    value += wt * feats[v, :, yy, xx]
            if depth > 0 or not mask_depth:
                per_view[v] = value
        out[:, n] = (per_view * torch.softmax(per_view, dim=0)).sum(0)
    return out


def test_unprojection_against_a_loop():
    spec = toy_spec()
    ring = frames.make_ring(spec, TRAFFIC, 11, CPU)
    batch = frame_batch(ring, 0)
    V = batch.views.shape[1]
    gen = torch.Generator().manual_seed(0)
    feats = torch.randn((1, V, 4, 16, 16), generator=gen)
    # cube points around the subject's pelvis; points far outside every
    # image; points 1 m behind each camera on its optical axis, whose
    # projection lands on that image's centre
    pelvis = torch.from_numpy(ring.joints[0, 0, 6])
    cube = grid_of(cube_axes(pelvis[None], [2500.0] * 3, [4, 4, 4]))[0]
    far = torch.tensor([[40000.0, 0.0, 800.0], [0.0, -500.0, 60000.0]])
    behind = ring.rig["T"][:, :, 0] - 1000.0 * ring.rig["R"][:, 2]
    points = torch.cat([cube, far, behind])
    got = unproject(feats, batch.view_data, points[None], [64, 64])[0]
    want = _unproject_loop(feats[0], ring.rig, points, [64, 64])
    # float32: the port's batched products against the loop's scalar ones
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    pix = G.project_points(points[None].expand(V, -1, -1),
                           *(ring.rig[k] for k in "RTfckp"))
    inside = ((pix >= 0) & (pix < 1000.0)).all(-1)  # (V, N)
    # the cube is seen by two views or more, and by none far away, where
    # the uniform softmax over zeros gives zero
    assert (inside[:, :len(cube)].sum(0) >= 2).float().mean() > 0.5
    assert not inside[:, len(cube):len(cube) + 2].any()
    assert torch.equal(got[:, len(cube):len(cube) + 2],
                       torch.zeros(4, 2))
    # behind camera v, its projection is the image's centre, inside it,
    # and the point reads as the loop that zeroes view v's entry, not as
    # one that samples it
    behind_at = slice(len(cube) + 2, len(points))
    assert inside[torch.arange(V), torch.arange(V) + len(cube) + 2].all()
    sampled = _unproject_loop(feats[0], ring.rig, points[behind_at],
                              [64, 64], mask_depth=False)
    assert ((got[:, behind_at] - sampled).abs().amax(0) > 1e-3).all()


def _unscaled_svd(proj, points):
    """The paper's algebraic DLT with equal weights: the null vector of
    the unscaled 2V x 4 system by float64 SVD."""
    A = proj[..., 2:3, :] * points[..., :, :, None] - proj[..., :2, :]
    A = A.reshape(A.shape[:-3] + (-1, 4)).double()
    v = torch.linalg.svd(A)[2][..., -1, :]
    return (v[..., :3] / v[..., 3:]).float()


def test_pelvis_matches_the_reference_dlt(record_property):
    spec = toy_spec()
    net, _, _, ring = served(spec, 2 ** 31 + 7)
    s = spec["settings"]
    gaps = []
    for i in range(len(ring)):
        batch = frame_batch(ring, i)
        hm = heatmaps(net, batch)
        with torch.no_grad():
            got = net.pelvis(hm[:, :, 6], batch.view_data, [64, 64])
        rig = ref_model.rig_of(ring.frame([i], CPU))
        want = ref_lt.base_points([hm[:, v] for v in range(hm.shape[1])],
                                  rig, s)
        assert (got - want).abs().max() < PELVIS_ATOL_MM
        # the paper's solve of the same undistorted points
        xy = torch.stack([ref_lt.integrate_2d(hm[:, v, 6:7], 100.0)[:, 0]
                          for v in range(hm.shape[1])], dim=1) * 4.0
        und = G.undistort_points(G.apply_affine(
            xy[:, :, None], rig["inv_affine"]), *(rig[k] for k in "fckp"))
        proj = G.projection_matrices(rig["R"], rig["T"], rig["f"], rig["c"])
        gaps.append(float((_unscaled_svd(proj, und[:, :, 0]) - want).norm()))
    record_property("unscaled_svd_gap_mm", max(gaps))


def _drawn_at(xy, h: int, w: int, multiplier: float) -> torch.Tensor:
    """An (h, w) map whose soft-argmax (times `multiplier`) is the heatmap
    pixel `xy`: the softmax's mass on the four pixels around it, split
    bilinearly, and none elsewhere."""
    x0, y0 = int(xy[0]), int(xy[1])
    fx, fy = float(xy[0]) - x0, float(xy[1]) - y0
    hm = torch.full((h, w), -1e4)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            hm[y0 + dy, x0 + dx] = float(torch.log(torch.tensor(
                wx * wy))) / multiplier
    return hm


def test_pelvis_of_maps_drawn_at_the_subject():
    """Heatmaps whose soft-argmax is the subject's pelvis in each view:
    the stage gives the subject's pelvis, on every ring frame whose pelvis
    every view holds."""
    spec = toy_spec()
    net, _, _, ring = served(spec, 13)
    checked = 0
    for i in range(len(ring)):
        pelvis = torch.from_numpy(ring.joints[i, 0, 6])
        batch = frame_batch(ring, i)
        V = batch.views.shape[1]
        pix = G.project_points(pelvis[None, None].expand(V, 1, 3),
                               *(ring.rig[k] for k in "RTfckp"))
        at = G.apply_affine(pix, ring.rig["affine"])[:, 0] / 4.0
        if not ((at >= 0) & (at < 15)).all():
            continue
        hm = torch.stack([_drawn_at(at[v], 16, 16, 100.0)
                          for v in range(V)])[None]
        with torch.no_grad():
            got = net.pelvis(hm, batch.view_data, [64, 64])[0]
        assert (got - pelvis).norm() < DRAWN_PELVIS_MM
        checked += 1
    assert checked


@pytest.mark.parametrize("config", sorted(STATE_DIGESTS))
def test_other_models_state_dicts_unchanged(config):
    spec = json.loads((CHECKOUT / "benchmark" / "configs"
                       / f"{config}.json").read_text())
    net = program.model(program.config(spec), CPU)
    lines = "".join(f"{k}:{tuple(v.shape)}:{v.dtype}\n"
                    for k, v in net.state_dict().items())
    assert hashlib.sha256(lines.encode()).hexdigest() == STATE_DIGESTS[config]
    assert not any(k.startswith(("process_features", "volume_net"))
                   for k in net.state_dict())


def test_spans_and_counter_in_a_profiled_step():
    spec = toy_spec()
    _, step, _, ring = served(spec, 2 ** 33 + 1)
    before = copy.copy(profiling.COUNTERS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pred = step(frame_batch(ring, 0))
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.name.startswith("mvg."))
    names = [n for *_, n in spans]
    lt = [sp for sp in spans if sp[2].startswith("mvg.lt.")]
    assert [n for *_, n in lt] == ["mvg.lt.pelvis", "mvg.lt.volume",
                                   "mvg.lt.v2v", "mvg.lt.softargmax"]
    assert set(names) <= set(profiling.SPANS)
    (step_span,) = [sp for sp in spans if sp[2] == "mvg.step"]
    (backbone,) = [sp for sp in spans if sp[2] == "mvg.backbone"]
    for a, b in zip([backbone] + lt, lt):
        assert a[1] <= b[0]  # in order, none nests another
    assert all(step_span[0] <= a and b <= step_span[1]
               for a, b, _ in [backbone] + lt)
    assert "mvg.pred" in names
    # the pelvis's DLT opens the DQ decoder's DLT span, inside its own
    (dlt,) = [sp for sp in spans if sp[2] == "mvg.dlt"]
    assert lt[0][0] <= dlt[0] and dlt[1] <= lt[0][1]
    moved = profiling.COUNTERS[VIEW_VOLUMES] - before.get(VIEW_VOLUMES, 0)
    assert moved == 3
    assert pred.shape == (1, 1, J, 5)


@pytest.mark.parametrize("setting,value,match", [
    ("PARALLEL.COMPUTE_DTYPE", "bfloat16", "float32"),
    ("PICT_STRUCT.CUBE_SIZE", [32, 32, 48], "multiple of 32"),
    ("NETWORK.BASE_JOINT", 17, "not one of the 17 joints")])
def test_build_refuses_what_the_port_does_not_run(setting, value, match):
    cfg = program.config(toy_spec(**{setting: value}))
    with pytest.raises(ValueError, match=match):
        program.model(cfg, CPU)


def test_training_refuses_the_volumetric_model():
    from mvgformer_tpu_torch.core.train import (make_eval_loss_step,
                                                make_train_step)

    cfg = program.config(toy_spec())
    for make in (make_train_step, make_eval_loss_step):
        with pytest.raises(ValueError,
                           match="serves the volumetric triangulation"):
            make(cfg, torch.nn.Module(), 0.3)


@pytest.mark.gpu
def test_served_step_makes_no_host_synchronization():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cuda = torch.device("cuda")
    spec = toy_spec()
    _, step, drawn, ring = served(spec, 2 ** 31 + 9, cuda)
    step(frame_batch(ring, 0))  # the first call makes the cached constants
    batch = frame_batch(ring, 1)
    launches, plain = fused_dlt.launches, fused_dlt.plain_calls
    torch.cuda.synchronize()
    pred, syncs = profiling.count_syncs(step, batch)
    assert syncs == 0
    # the pelvis took the DLT kernel, once
    assert (fused_dlt.launches - launches, fused_dlt.plain_calls - plain) \
        == (1, 0)
    assert pred.shape == (1, 1, J, 5) and torch.isfinite(pred).all()
    # the card's pred against the float32 reference on the CPU
    want = ref_lt.frame(spec, ref_model.Net(
        {k: v.cpu() for k, v in drawn.items()}), {
            k: v.cpu() for k, v in ring.frame([1], cuda).items()})["pred"]
    assert (pred.cpu()[..., :3] - want[..., :3]).abs().max() < POSE_ATOL_MM
