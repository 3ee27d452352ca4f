"""The volumetric Learnable Triangulation model's configuration
(`ltvol_h36m4`) through the loop of its cell `ltvol_serve_live_b1` at toy
sizes on the CPU: a run through `run.run_cell` with the program's plain
path, the reference's pred, the TF32 control against the cell's own
limits, the FLOP count against a hand count of the V2V and against
PyTorch's own counter on the reference frame, and the cell's three
per-layer readers on a synthetic record.

Toy sizes: PoseResNet-18 with 32 deconvolution filters, 64x64 images,
3 views, a 32^3 cube (the five pools need a multiple of 32) and 4
processed channels, one subject a frame in 1000x1000 images.
"""

from __future__ import annotations

import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import harness_toy  # noqa: F401  (puts the checkout on the path)

from benchmark import check, flops, frames, program, run, weights
from benchmark.flops import volumetric_triangulation as lt_flops
from benchmark.reference import model as ref_model

CELL = run.cell_of(run.benchmark(), "ltvol_serve_live_b1")
TOY = {"NETWORK.IMAGE_SIZE": [64, 64], "NETWORK.HEATMAP_SIZE": [16, 16],
       "POSE_RESNET.NUM_LAYERS": 18,
       "POSE_RESNET.NUM_DECONV_FILTERS": [32, 32, 32],
       "DATASET.CAMERA_NUM": 3, "PICT_STRUCT.CUBE_SIZE": [32, 32, 32],
       "NETWORK.VOLUME_FEATURES": 4}
TRAFFIC = {"loop": "serve_closed", "batch": 1, "ring_frames": 4,
           "people": [1], "cam_seed": 0, "image_wh": [1000, 1000],
           "warmup_units": 1, "trace_units": 1, "check_units": 2}
# the program's runs here with toy limits: the float32 program against
# the float32 reference reads rounding at these sizes (joints ~0.003 mm
# apart, the score exact), so 1e-4 and 0.1 mm sit far above it and far
# below a wrong answer
LIMITS = {"score_gap": 1e-4, "pose_gap_mm": 0.1,
          "frame_pose_gap_p50_mm": 0.1, "frame_pose_gap_p99_mm": 0.1}
CELL_LIMITS = run.load_json(run.HERE / "limits" / "ltvol_serve_live_b1.json")
CPU = torch.device("cpu")


def spec() -> dict:
    out = run.load_json(run.HERE / "configs" / "ltvol_h36m4.json")
    out["settings"].update(TOY)
    return out


def run_toy(seed: int, keep: bool = False) -> dict:
    torch.set_num_threads(2)
    return run.run_cell(run.benchmark(), CELL, seed, 2.0, False, CPU,
                        time.perf_counter(), keep=keep, spec=spec(),
                        traffic=dict(TRAFFIC), limits=dict(LIMITS))


def test_toy_cell_is_correct_and_the_control_is_not():
    """The program is correct under the toy limits; the control (the
    reference in TF32, in the program's place) is not correct under the
    cell's own limits."""
    out = run_toy(2 ** 31 + 5, keep=True)
    result = out["result"]
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 2 and result["failed"] == 0
    assert out["values"]["score_gap"] == 0.0
    assert 0 < out["values"]["pose_gap_mm"] < 0.05
    units = [indices for indices, _ in out["judged"]]
    got = check.control(spec(), out["weights"], out["ring"], units, CPU)
    ctl = check.readings(spec(), out["weights"], out["ring"], got, CPU)
    checks, ok = run.judge(ctl, CELL_LIMITS)
    assert not ok, checks


def test_reference_pred_is_one_row_of_every_joint():
    sp = spec()
    net = program.model(program.config(sp), CPU)
    drawn = weights.draw(weights.float_shapes(net), 3, CPU)
    ring = frames.make_ring(sp, TRAFFIC, 3, CPU)
    out = check.family(sp)(sp, ref_model.Net(drawn), ring.frame([0], CPU))
    pred = out["pred"]
    assert pred.shape == (1, 1, 17, 5)
    assert torch.equal(pred[..., 3:], torch.tensor([0.0, 1.0]).expand(
        1, 1, 17, 2))
    # the joints lie in the cube around the triangulated base point
    offset = (pred[0, 0, :, :3] - out["base"][0]).abs()
    assert offset.max() <= 1250.0


def _conv3d(cin, cout, k, voxels):
    return 2 * cin * cout * k ** 3 * voxels


def _res(cin, cout, voxels):
    return (_conv3d(cin, cout, 3, voxels) + _conv3d(cout, cout, 3, voxels)
            + (_conv3d(cin, cout, 1, voxels) if cin != cout else 0))


def test_v2v_flops_by_hand():
    """V2VModel(4, 17) at 32^3, convolution by convolution."""
    n = [32 ** 3 // 8 ** i for i in range(6)]  # voxels at levels 0-5
    want = (_conv3d(4, 16, 7, n[0]) + _res(16, 32, n[0])
            + 2 * _res(32, 32, n[0])  # front_layers
            + _res(32, 32, n[0]) + _res(32, 64, n[1])  # skip, encoder 1
            + _res(64, 64, n[1]) + _res(64, 128, n[2])  # level 2
            + _res(128, 128, n[2]) + _res(128, 128, n[3])  # level 3
            + _res(128, 128, n[3]) + _res(128, 128, n[4])  # level 4
            + _res(128, 128, n[4]) + _res(128, 128, n[5])  # level 5
            + _res(128, 128, n[5])  # mid_res
            + _res(128, 128, n[5]) + _conv3d(128, 128, 2, n[5])  # decoder 5
            + _res(128, 128, n[4]) + _conv3d(128, 128, 2, n[4])  # 4
            + _res(128, 128, n[3]) + _conv3d(128, 128, 2, n[3])  # 3
            + _res(128, 128, n[2]) + _conv3d(128, 64, 2, n[2])  # 2
            + _res(64, 64, n[1]) + _conv3d(64, 32, 2, n[1])  # 1
            + _res(32, 32, n[0]) + 2 * _conv3d(32, 32, 1, n[0])  # back
            + _conv3d(32, 17, 1, n[0]))  # output_layer
    assert lt_flops.v2v_model(4, 17, [32, 32, 32]) == want
    from mvgformer_tpu_torch.models.v2v import V2VModel

    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        V2VModel(4, 17).eval()(torch.zeros(1, 4, 32, 32, 32))
    assert counter.get_total_flops() == want


def test_matmul_flops_match_torchs_counter():
    sp = spec()
    net = program.model(program.config(sp), CPU)
    drawn = weights.draw(weights.float_shapes(net), 11, CPU)
    ring = frames.make_ring(sp, TRAFFIC, 11, CPU)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        check.family(sp)(sp, ref_model.Net(drawn), ring.frame([0], CPU))
    counted = counter.get_total_flops()
    want = flops.serve_frame_parts(sp["settings"])["matmul"]
    # torch also counts the expected point's product over the voxels and
    # the geometry's small products (the cube's turn by 0, the depths,
    # the crop affines), which the model count leaves out
    assert want <= counted <= want * 1.01


@pytest.mark.parametrize("name,want", [
    ("lt_volume_device_ms.serve", 1.5), ("lt_v2v_device_ms.serve", 23.0),
    ("lt_view_volumes_per_frame.serve", 4.0)])
def test_readers_on_a_synthetic_record(name, want):
    reader = run.module_at(run.HERE / "metrics" / f"{name}.py")
    record = {"frames": 2, "counters": {"volumetric.view_volumes": 8},
              "spans": {"mvg.lt.volume": {"device_s": 0.003},
                        "mvg.lt.v2v": {"device_s": 0.046},
                        "mvg.vp.volume": {"device_s": 1.0}}}
    assert reader.read(record) == pytest.approx(want)
    # the other models' records: no span, no count
    assert reader.read({"frames": 2, "counters": {},
                        "spans": {"mvg.vp.volume": {"device_s": 1.0}}}) \
        is None
    assert reader.read({"frames": 2}) is None
