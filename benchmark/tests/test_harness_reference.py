"""The plain reference against the port's plain path, and the control
against the program, at toy widths on the CPU."""

from __future__ import annotations

import pytest
import torch

import harness_toy

from benchmark import check, run


@pytest.mark.parametrize("config", sorted(harness_toy.CONFIGS))
def test_reference_agrees_with_the_ports_plain_path(config):
    out = harness_toy.run_toy(config)
    assert out["result"]["correct"], out["result"]["checks"]
    values = out["values"]
    assert values["score_gap"] < 1e-5
    assert values["frame_pose_gap_p99_mm"] < 0.05


@pytest.mark.parametrize("config", sorted(harness_toy.CONFIGS))
def test_control_fails_where_the_stated_precision_passes(config):
    """The control (the reference in the configuration's control
    precision, in the program's place) reads at least three times what
    the program in the configuration's own precision reads on a per-frame
    median of the pose or the score gap, on three seeds."""
    cpu = torch.device("cpu")
    dtype = harness_toy.stated_dtype(config)
    for seed in (2 ** 31 + 11, 2 ** 33 + 7, 5):
        out = harness_toy.run_toy(config, seed=seed, dtype=dtype, keep=True)
        units = [indices for indices, _ in out["judged"]]
        spec = harness_toy.spec(config, dtype)
        got = check.control(spec, out["weights"], out["ring"], units, cpu)
        ctl = check.readings(spec, out["weights"], out["ring"], got, cpu)
        low = out["values"]
        assert any(ctl[k] >= 3 * low[k] for k in
                   ("frame_pose_gap_p50_mm", "frame_score_gap_p50")), (
            low, ctl)


def test_reference_training_agrees_with_the_ports_step():
    out = harness_toy.run_toy_train()
    assert out["result"]["correct"], out["result"]["checks"]


def test_training_control_fails_where_bfloat16_passes():
    """The control reads at least twice the bfloat16 program's gap of the
    median leaf's first gradient or change, or of the classification
    loss, on three seeds (at these widths bfloat16's rounding weighs more
    than at the cell's, where PERF.md gives the readings)."""
    cpu = torch.device("cpu")
    loop = run.module_at(run.HERE / "loops" / "train.py")
    for seed in (5, 2 ** 31 + 3, 2 ** 33 + 9):
        out = harness_toy.run_toy_train(seed, "bfloat16", keep=True)
        spec = harness_toy.spec("mvgformer_panoptic5", "bfloat16")
        ctl = loop.control(spec, out, seed, cpu)
        low = out["values"]
        assert any(ctl[k] >= 2 * low[k] for k in
                   ("grad_gap_p50", "change_gap_p50", "ce_gap")), (low, ctl)
