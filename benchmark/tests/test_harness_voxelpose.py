"""VoxelPose's configuration (`voxelpose_panoptic5`) through the loop of
its cell `vp_serve_live_b1` at toy sizes on the CPU: a run through
`run.run_cell` with the program's plain path, the TF32 control against
the program at the published threshold under the cell's own limits, the
check's blind spot on a frame with no proposal, and the FLOP count against
PyTorch's own counter on the reference frame.

At the published threshold of 0.3 the drawn weights leave most frames with
no valid candidate, whose rows hold xyz 0 on both sides, so `check.py`
compares the pose network's joints on few seeds; on a frame whose root
cube is negative everywhere every row holds zeros and a score of -0.0,
and any pred of zeros reads correct (PERF.md secs. 2 and 7). The tests
below pin both.

Toy sizes: PoseResNet-18 with 32 deconvolution filters, 96x64 images,
3 views, an 8x8x4 root grid, an 8^3 pose grid and 4 candidates. At these
sizes the drawn weights give root scores of about 0.05-0.15, under the
published threshold, so the plain run takes a threshold of 0 (every
candidate valid and its joints compared), and the runs at the published
threshold shift the root network's output bias by a stated amount.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import harness_toy

from benchmark import check, flops, frames, program, run, weights
from benchmark.reference import model as ref_model

CELL = run.cell_of(run.benchmark(), "vp_serve_live_b1")
PUBLISHED_THRESHOLD = 0.3
ROOT_BIAS = "root_net.output_layer.bias"
TOY = {"NETWORK.IMAGE_SIZE": [96, 64], "NETWORK.HEATMAP_SIZE": [24, 16],
       "POSE_RESNET.NUM_LAYERS": 18,
       "POSE_RESNET.NUM_DECONV_FILTERS": [32, 32, 32],
       "DATASET.CAMERA_NUM": 3, "MULTI_PERSON.INITIAL_CUBE_SIZE": [8, 8, 4],
       "PICT_STRUCT.CUBE_SIZE": [8, 8, 8], "MULTI_PERSON.MAX_PEOPLE_NUM": 4,
       "DECODER.num_instance": 4, "MULTI_PERSON.THRESHOLD": 0.0}
# the program's runs here with toy limits: the float32 program against
# the float32 reference reads rounding at these sizes (scores under 1e-7
# apart, joints under 0.01 mm), so 1e-4 and 0.1 mm sit far above it and
# far below a wrong answer
LIMITS = {"score_gap": 1e-4, "pose_gap_mm": 0.1}
# the cell's own limits, which the control and the blind spot are judged by
CELL_LIMITS = run.load_json(run.HERE / "limits" / "vp_serve_live_b1.json")
CPU = torch.device("cpu")


def spec() -> dict:
    out = run.load_json(run.HERE / "configs" / "voxelpose_panoptic5.json")
    out["settings"].update(TOY)
    return out


def run_toy(seed: int, keep: bool = False, **settings) -> dict:
    torch.set_num_threads(2)
    sp = spec()
    sp["settings"].update(settings)
    return run.run_cell(run.benchmark(), CELL, seed, 0.5, False, CPU,
                        time.perf_counter(), keep=keep, spec=sp,
                        traffic=harness_toy.traffic(), limits=dict(LIMITS))


def shift_root_bias(monkeypatch, shift: float) -> None:
    """The cell's weights as drawn, with `shift` added to the root
    network's output bias: every root score moves by it."""
    plain = weights.draw

    def draw(shapes, seed, device):
        out = plain(shapes, seed, device)
        out[ROOT_BIAS] = out[ROOT_BIAS] + shift
        return out

    monkeypatch.setattr(weights, "draw", draw)


def test_toy_cell_is_correct():
    out = run_toy(2 ** 31 + 5)
    result = out["result"]
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 2 and result["failed"] == 0
    assert out["values"]["score_gap"] < 1e-6
    assert 0 < out["values"]["pose_gap_mm"] < 0.05


@pytest.mark.parametrize("seed", [2 ** 31 + 11, 2 ** 33 + 7, 5])
def test_tf32_control_not_correct_at_the_published_threshold(
        monkeypatch, seed):
    """At the published threshold, on root scores lifted by 0.5 so that
    candidates clear it: the program is correct under the toy limits, and
    the control (the reference in TF32, in the program's place) is not
    correct under the cell's own limits."""
    shift_root_bias(monkeypatch, 0.5)
    out = run_toy(seed, keep=True,
                  **{"MULTI_PERSON.THRESHOLD": PUBLISHED_THRESHOLD})
    assert out["result"]["correct"], out["result"]["checks"]
    assert any((pred[..., 0, 3] == 0).any() for _, pred in out["judged"])
    units = [indices for indices, _ in out["judged"]]
    sp = spec()
    sp["settings"]["MULTI_PERSON.THRESHOLD"] = PUBLISHED_THRESHOLD
    got = check.control(sp, out["weights"], out["ring"], units, CPU)
    ctl = check.readings(sp, out["weights"], out["ring"], got, CPU)
    checks, ok = run.judge(ctl, CELL_LIMITS)
    assert not ok, checks


def test_no_proposal_frame_reads_any_pose_correct(monkeypatch):
    """The check's blind spot, pinned: where the root cube is negative
    everywhere, the NMS leaves the top scores at -0.0, every row of both
    preds is invalid with xyz 0, and no row is compared for pose: a pred
    whose joints are a metre off, or one that a step computed nothing
    for, reads correct under the cell's limits. A change to `check.py`
    that reads such a frame (PERF.md sec. 7) changes this test with it."""
    shift_root_bias(monkeypatch, -10.0)
    out = run_toy(2 ** 31 + 5, keep=True,
                  **{"MULTI_PERSON.THRESHOLD": PUBLISHED_THRESHOLD})
    assert out["result"]["correct"]
    for _, pred in out["judged"]:
        assert not pred[..., :3].any() and not pred[..., 4].any()
        assert (pred[..., 3] == -1).all()
    wrong = []
    for indices, pred in out["judged"]:
        off = np.zeros_like(pred)
        off[..., :3], off[..., 3] = 1000.0, -1.0
        wrong.append((indices, off))
    sp = spec()
    sp["settings"]["MULTI_PERSON.THRESHOLD"] = PUBLISHED_THRESHOLD
    values = check.readings(sp, out["weights"], out["ring"], wrong, CPU)
    assert values["score_gap"] == 0 and values["pose_gap_mm"] == 0
    assert run.judge(values, CELL_LIMITS)[1]


def test_matmul_flops_match_torchs_counter():
    """The count's `matmul` against FlopCounterMode over the reference
    frame, with every candidate valid (a threshold under every score), so
    that the reference runs the PRN on each, as the program does."""
    sp = spec()
    sp["settings"]["MULTI_PERSON.THRESHOLD"] = -1e9
    net = program.model(program.config(sp), CPU)
    drawn = weights.draw(weights.float_shapes(net), 11, CPU)
    ring = frames.make_ring(sp, harness_toy.traffic(), 11, CPU)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        check.family(sp)(sp, ref_model.Net(drawn), ring.frame([0], CPU))
    counted = counter.get_total_flops()
    want = flops.serve_frame_parts(sp["settings"])["matmul"]
    # torch also counts the projections' and crop affines' small products
    # (3x3 and 2x3 per voxel and view), which the model count leaves out
    assert want <= counted <= want * 1.01
