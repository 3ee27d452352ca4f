"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, the rest of the run driven at toy
widths on the CPU, once for each fault the serving cells can have."""

from __future__ import annotations

import pytest
import torch

import harness_toy

from benchmark import check, program, run, weights
from benchmark.reference import model as ref_model
from benchmark.reference import precision


def broken(fault):
    make = program.eval_step

    def eval_step(cfg, net, threshold):
        step = make(cfg, net, threshold)

        def run(batch):
            pred = step(batch)
            return fault(pred, batch)

        return run

    return eval_step


def alter_answer(pred, batch):
    """One frame's answer altered where it is produced: its kept queries'
    joints moved by 300 mm."""
    pred = pred.clone()
    kept = pred[0, :, 0, 4] > 2e-5
    pred[0, kept, :, 0] += 300.0
    return pred


def half_batch(pred, batch):
    """Half of the batch left out: the second half's answers are the
    first half's."""
    pred = pred.clone()
    half = pred.shape[0] // 2
    pred[half:2 * half] = pred[:half]
    return pred


@pytest.mark.parametrize("config", sorted(harness_toy.CONFIGS))
def test_sound_run_is_correct(config):
    assert harness_toy.run_toy(config, batch=4)["result"]["correct"]


@pytest.mark.parametrize("fault", [alter_answer, half_batch],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("config", sorted(harness_toy.CONFIGS))
def test_fault_is_not_correct(config, fault, monkeypatch):
    monkeypatch.setattr(program, "eval_step", broken(fault))
    out = harness_toy.run_toy(config, batch=4)
    assert not out["result"]["correct"], out["result"]["checks"]


def unchanged_state(monkeypatch):
    """A training step that returns its state unchanged: the port's step
    runs, then the parameters are put back and the old state returned."""
    make = program.train_step

    def train_step(cfg, net):
        state, step = make(cfg, net)

        def run(state, batch, generator):
            before = {k: p.detach().clone()
                      for k, p in net.named_parameters()}
            _, metrics = step(state, batch, generator)
            with torch.no_grad():
                for k, p in net.named_parameters():
                    p.copy_(before[k])
            return state, metrics

        return state, run

    monkeypatch.setattr(program, "train_step", train_step)


def test_training_sound_run_is_correct():
    assert harness_toy.run_toy_train()["result"]["correct"]


def test_training_step_returning_its_state_unchanged_is_not_correct(
        monkeypatch):
    unchanged_state(monkeypatch)
    out = harness_toy.run_toy_train()
    assert not out["result"]["correct"], out["result"]["checks"]
    assert out["values"]["change_gap"] == pytest.approx(1.0)


def planted_control(config, monkeypatch):
    """The control in the program's place: the serving step replaced by
    the plain reference in the configuration's control precision on the
    weights the run drew."""
    drawn = {}
    load = weights.load

    def keep(net, tensors):
        drawn.update(tensors)
        return load(net, tensors)

    def eval_step(cfg, net, threshold):
        spec = harness_toy.spec(config)
        frame_fn = check.family(spec)

        def step(batch):
            ref = ref_model.Net(drawn, precision.control(spec))
            vd = batch.view_data
            preds = []
            for b in range(batch.views.shape[0]):
                frame = {k: getattr(vd.cameras, k)[b:b + 1] for k in "RTfckp"}
                frame.update({k: getattr(vd, k)[b:b + 1] for k in (
                    "centers", "scales", "affine", "inv_affine")},
                    views=batch.views[b:b + 1])
                with torch.no_grad():
                    preds.append(frame_fn(spec, ref, frame)["pred"][0])
            return torch.stack(preds)

        return step

    monkeypatch.setattr(weights, "load", keep)
    monkeypatch.setattr(program, "eval_step", eval_step)


@pytest.mark.parametrize("config", sorted(harness_toy.CONFIGS))
def test_planted_control_is_not_correct(config, monkeypatch):
    planted_control(config, monkeypatch)
    out = harness_toy.run_toy(config, batch=2, seconds=4.0)
    assert out["failed"] == 0
    assert not out["result"]["correct"], out["result"]["checks"]


def test_training_control_is_not_correct():
    """The control's numbers of the checked steps, judged by the cell's
    comparison (`run.judge`) against the toy limits."""
    loop = run.module_at(run.HERE / "loops" / "train.py")
    out = harness_toy.run_toy_train(keep=True)
    assert out["result"]["correct"]
    values = loop.control(harness_toy.spec("mvgformer_panoptic5"), out,
                          2 ** 31 + 77, torch.device("cpu"))
    checks, ok = run.judge(values, harness_toy.TRAIN_LIMITS)
    assert not ok, checks
