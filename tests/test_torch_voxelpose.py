"""VoxelPose on the port's serving path (`models/voxelpose.py`,
`models/v2v.py`, `core/infer.py::make_eval_step`) against the plain
reference of the benchmark (`benchmark/reference/voxelpose.py`, which
imports nothing of the port), at toy sizes on the CPU: PoseResNet-18 with
32 deconvolution filters, 96x64 images, 3 views, an 8x8x4 root grid, an
8^3 pose grid and 4 candidates, on weights drawn from a seed by name and
shape (`benchmark/weights.py`) and the benchmark's synthetic frames.

  * the served pred against the reference's, row for row, with a
    threshold that leaves some candidates invalid;
  * V2VNet alone against the reference's;
  * the volume projection against a loop over voxels and views, with
    voxels inside and outside the images;
  * MVGFormer's and MvP's state dicts (names, shapes, order) as they were,
    so the weights the benchmark draws for them are too;
  * the VoxelPose spans and counters in a profiled step.

On the card (`-m gpu`; this file imports no JAX, so `--noconftest` runs
it there): a served step makes no host synchronization.
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
from benchmark.reference import voxelpose as ref_vp
from mvgformer_tpu_torch.models.v2v import V2VNet
from mvgformer_tpu_torch.models.voxelpose import grid_points, sample_volume
from mvgformer_tpu_torch.utils import profiling
from torch_one_thread import one_torch_thread  # noqa: F401

CHECKOUT = Path(__file__).resolve().parents[1]
TOY = {"NETWORK.IMAGE_SIZE": [96, 64], "NETWORK.HEATMAP_SIZE": [24, 16],
       "POSE_RESNET.NUM_LAYERS": 18,
       "POSE_RESNET.NUM_DECONV_FILTERS": [32, 32, 32],
       "DATASET.CAMERA_NUM": 3, "MULTI_PERSON.INITIAL_CUBE_SIZE": [8, 8, 4],
       "PICT_STRUCT.CUBE_SIZE": [8, 8, 8], "MULTI_PERSON.MAX_PEOPLE_NUM": 4,
       "DECODER.num_instance": 4}
TRAFFIC = {"loop": "serve_closed", "batch": 1, "ring_frames": 4,
           "people": [1, 2, 3, 4], "cam_seed": 0, "image_wh": [1920, 1080],
           "warmup_units": 1, "trace_units": 1, "check_units": 2}
CPU = torch.device("cpu")
# Both sides are float32 on the CPU and differ only in the order of their
# sums (the port's batched PRN, BatchNorm and soft-argmax product against
# the reference's per-candidate loop, folded BN and elementwise sum). The
# scores read up to 6e-8 apart and the joints up to 0.005 mm at coordinates
# of up to ~4000 mm, a few float32 ulps there; a wrong step (a voxel off,
# a missed clamp or view mask) moves a joint by millimetres.
SCORE_ATOL = 1e-6
POSE_ATOL_MM = 0.05
# the state dicts' (name, shape, dtype) lines, in order, at the
# benchmark's widths, as they were before VoxelPose
STATE_DIGESTS = {
    "mvgformer_panoptic5":
        "3d81ae36e85342ac29d0e6f5386082b231463840861bdda93490974e0ce3e4b2",
    "mvp_panoptic5":
        "97e4ed6dc554d19d5eab73afdfc2310bc1454c50ea6a6fe038ee2a6f72e50067"}


def toy_spec(**settings) -> dict:
    spec = json.loads((CHECKOUT / "benchmark" / "configs"
                       / "voxelpose_panoptic5.json").read_text())
    spec["settings"].update(TOY, **settings)
    return spec


def served(spec: dict, seed: int, device=CPU):
    """The port's model on weights drawn from `seed`, its eval step at the
    spec's threshold, the drawn weights and the ring of frames."""
    s = spec["settings"]
    cfg = program.config(spec)
    net = program.model(cfg, device)
    drawn = weights.draw(weights.float_shapes(net), seed, device)
    weights.load(net, drawn)
    ring = frames.make_ring(spec, TRAFFIC, seed, device)
    step = program.eval_step(cfg, net, s["MULTI_PERSON.THRESHOLD"])
    return net, step, drawn, ring


def frame_batch(ring, index: int, spec: dict):
    """The port's Batch of ring frame `index`, its views placed on the
    rig's device."""
    s = spec["settings"]
    return program.batch(ring.views[index:index + 1].to(
        ring.rig["R"].device), ring.rig_batch(1),
        s["MULTI_PERSON.MAX_PEOPLE_NUM"], s["DECODER.num_keypoints"])


def serve(step, ring, index: int, spec: dict):
    return step(frame_batch(ring, index, spec))


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 3])
def test_served_pred_matches_the_plain_reference(seed):
    spec = toy_spec()
    _, _, drawn, ring = served(spec, seed)
    net = ref_model.Net(drawn)
    # a threshold between the reference's second and third root scores of
    # frame 0, so that its rows 0-1 are valid and 2-3 invalid
    scores = ref_vp.frame(spec, net, ring.frame([0], CPU))["pred"][0, :, 0, 4]
    assert (scores[1] - scores[2]) > 1e-4, "a near tie at the threshold"
    threshold = float(scores[1] + scores[2]) / 2
    spec = toy_spec(**{"MULTI_PERSON.THRESHOLD": threshold})
    _, step, _, ring = served(spec, seed)
    flags = []
    for i in range(len(ring)):
        got = serve(step, ring, i, spec)[0]
        want = ref_vp.frame(spec, net, ring.frame([i], CPU))["pred"][0]
        assert got.shape == want.shape == (4, 15, 5)
        assert torch.equal(got[..., 3], want[..., 3])
        assert (got[..., 4] - want[..., 4]).abs().max() < SCORE_ATOL
        assert (got[..., :3] - want[..., :3]).abs().max() < POSE_ATOL_MM
        invalid = want[:, 0, 3] < 0
        assert torch.equal(got[invalid, :, :3],
                           torch.zeros_like(got[invalid, :, :3]))
        assert torch.all(got[:-1, 0, 4] >= got[1:, 0, 4])
        flags.append(want[:, 0, 3])
    flags = torch.stack(flags)
    assert (flags == 0).any() and (flags < 0).any()
    assert torch.equal(flags[0], torch.tensor([0.0, 0.0, -1.0, -1.0]))


def test_v2v_matches_the_reference():
    gen = torch.Generator().manual_seed(3)
    port = V2VNet(15, 15, generator=gen).eval()
    drawn = weights.draw({"pose_net." + k: s for k, s in
                          weights.float_shapes(port).items()}, 7, CPU)
    weights.load(port, {k[len("pose_net."):]: v for k, v in drawn.items()})
    x = torch.rand((2, 15, 8, 8, 8), generator=gen)
    with torch.no_grad():
        got = port(x)
        want = ref_vp.v2v(ref_model.Net(drawn), "pose_net", x)
    assert got.shape == want.shape == (2, 15, 8, 8, 8)
    # float32 in another order of sums (nn.BatchNorm3d against the folded
    # scale and shift): a few ulps of outputs of magnitude ~1
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def _sample_loop(hms, rig, points, image_wh):
    """Per voxel, per view: project, test the full image's bounds, clamp,
    crop, normalize, bilinear corners by hand; the mean over the views
    that see the voxel, clamped to [0, 1]."""
    V, J, h, w = hms.shape
    out = torch.zeros(J, len(points))
    for n, x in enumerate(points):
        total, seen = torch.zeros(J), 0
        for v in range(V):
            pix = G.project_points(x[None], *(rig[k][v] for k in "RTfckp"))[0]
            width, height = (rig["centers"][v] * 2.0).tolist()
            inside = (0 <= pix[0] < width) and (0 <= pix[1] < height)
            pix = torch.clamp(pix, -1.0, max(width, height))
            u, t = G.apply_affine(pix[None], rig["affine"][v])[0].tolist()
            u, t = u * w / image_wh[0], t * h / image_wh[1]
            gx = min(max(u / (w - 1) * 2 - 1, -1.1), 1.1)
            gy = min(max(t / (h - 1) * 2 - 1, -1.1), 1.1)
            fx, fy = (gx + 1) / 2 * (w - 1), (gy + 1) / 2 * (h - 1)
            x0, y0 = int(torch.floor(torch.tensor(fx))), int(
                torch.floor(torch.tensor(fy)))
            value = torch.zeros(J)
            for yy, xx in ((y0, x0), (y0, x0 + 1), (y0 + 1, x0),
                           (y0 + 1, x0 + 1)):
                wt = (1 - abs(fx - xx)) * (1 - abs(fy - yy))
                if 0 <= xx < w and 0 <= yy < h:
                    value += wt * hms[v, :, yy, xx]
            if inside:
                total += value
                seen += 1
        out[:, n] = torch.clamp(total / (seen + 1e-6), 0.0, 1.0)
    return out


def test_volume_projection_against_a_loop():
    spec = toy_spec()
    ring = frames.make_ring(spec, TRAFFIC, 11, CPU)
    batch = program.batch(ring.views[:1], ring.rig_batch(1), 4, 15)
    gen = torch.Generator().manual_seed(0)
    V = batch.views.shape[1]
    hms = torch.rand((1, V, 15, 16, 24), generator=gen) * 1.4 - 0.2
    # voxels of the capture space, and points outside some or every view:
    # far to the side, high above, behind a camera
    grid = grid_points(torch.tensor([0.0, -500.0, 800.0]),
                       [8000.0, 8000.0, 2000.0], [4, 4, 2])
    far = torch.tensor([[20000.0, 0.0, 800.0], [0.0, -500.0, 30000.0],
                        [-6000.0, 5000.0, 100.0]])
    points = torch.cat([grid, far, ring.rig["T"][0].T])
    got = sample_volume(hms, batch.view_data, points[None], [96, 64])[0]
    want = _sample_loop(hms[0], {k: v for k, v in ring.rig.items()}, points,
                        [96, 64])
    # float32: the port's batched products against the loop's scalar ones
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)
    pix = G.project_points(points[None].expand(V, -1, -1),
                           *(ring.rig[k] for k in "RTfckp"))
    inside = ((pix >= 0) & (pix < ring.rig["centers"][:, None] * 2)).all(-1)
    assert inside.all(0).any() and (~inside).all(0).any()
    assert (inside.any(0) & ~inside.all(0)).any()


@pytest.mark.parametrize("config", sorted(STATE_DIGESTS))
def test_other_models_state_dicts_unchanged(config):
    spec = json.loads((CHECKOUT / "benchmark" / "configs"
                       / f"{config}.json").read_text())
    net = program.model(program.config(spec), CPU)
    lines = "".join(f"{k}:{tuple(v.shape)}:{v.dtype}\n"
                    for k, v in net.state_dict().items())
    assert hashlib.sha256(lines.encode()).hexdigest() == STATE_DIGESTS[config]
    assert not any("final_layer" in k for k in net.state_dict())


def test_spans_and_counters_in_a_profiled_step():
    spec = toy_spec(**{"MULTI_PERSON.THRESHOLD": -1.0})
    _, step, _, ring = served(spec, 2 ** 33 + 1)
    before = copy.copy(profiling.COUNTERS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pred = serve(step, ring, 0, spec)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.name.startswith("mvg."))
    names = [n for *_, n in spans]
    vp = [sp for sp in spans if sp[2].startswith("mvg.vp.")]
    assert [n for *_, n in vp] == ["mvg.vp.volume", "mvg.vp.cpn",
                                   "mvg.vp.propose", "mvg.vp.volume",
                                   "mvg.vp.prn", "mvg.vp.softargmax"]
    assert set(names) <= set(profiling.SPANS)
    (step_span,) = [sp for sp in spans if sp[2] == "mvg.step"]
    for a, b in zip(vp, vp[1:]):
        assert a[1] <= b[0]  # none nests another
    assert all(step_span[0] <= a and b <= step_span[1] for a, b, _ in vp)
    assert {"mvg.backbone", "mvg.pred"} <= set(names)
    moved = {k: profiling.COUNTERS[k] - before.get(k, 0)
             for k in ("voxelpose.root_volumes", "voxelpose.prn_volumes")}
    assert moved == {"voxelpose.root_volumes": 1,
                     "voxelpose.prn_volumes": 4}
    assert (pred[0, :, 0, 3] == 0).all()


def test_training_refuses_voxelpose():
    from mvgformer_tpu_torch.core.train import make_eval_loss_step

    cfg = program.config(toy_spec())
    with pytest.raises(ValueError, match="serves VoxelPose only"):
        make_eval_loss_step(cfg, torch.nn.Module(), 0.3)


@pytest.mark.gpu
def test_served_step_makes_no_host_synchronization():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cuda = torch.device("cuda")
    spec = toy_spec(**{"MULTI_PERSON.THRESHOLD": 0.0})
    _, step, _, ring = served(spec, 2 ** 31 + 9, cuda)
    serve(step, ring, 0, spec)  # the first call makes the cached constants
    batch = frame_batch(ring, 1, spec)
    torch.cuda.synchronize()
    pred, syncs = profiling.count_syncs(step, batch)
    assert syncs == 0
    assert pred.shape == (1, 4, 15, 5) and torch.isfinite(pred).all()
