"""The training step reads nothing back from its device, on the CPU.

On the card a read of a device tensor into Python (`bool`, `float`,
`int`, `.item()`, `.tolist()`, `.numpy()`) waits for every queued kernel;
a step that makes none can be dispatched back to back, as the fast trainer
(mvgformer_tpu_torch/tools/ap_train_fast.py) does. Here each of those
reads raises while the code under test runs (`no_host_reads`); the one
read allowed is the dropout seeds' draw from a CPU generator
(models/decoder.py::host_seeds), which is a host tensor on the card
too. On the card, chip_smoke.py phase 24b counts the synchronizations of
each step under torch.cuda.set_sync_debug_mode.

  * the clipped Adam with TRAIN.SKIP_NONFINITE against optax's
    apply_if_finite(chain(clip, adam), 100), as make_optimizer composes
    it: a NaN gradient at step 2 (dropped: the parameters, moments and
    count unchanged), and 100 non-finite steps in a row with the 101st
    applied; parameters at rtol 1e-5, the counters equal, no host read in
    any update;
  * one DQ training step (KNN gt match, dropout 0.1 from a CPU generator,
    remat, SKIP_NONFINITE, TRI_GRAD_CLIP, TRAIN_BACKBONE, Jacobi DLT) on
    the toy config: no host read, the counters 0-d tensors, the losses
    finite.
"""

import sys

import numpy as np
import pytest
import torch

import test_torch_train_optim as optim_tests
from mvgformer_tpu_torch.config import load_config
from mvgformer_tpu_torch.core import train
from mvgformer_tpu_torch.data.synthetic import make_batch
from mvgformer_tpu_torch.models.mvgformer import MVGFormer
from torch_one_thread import one_torch_thread  # noqa: F401

READS = ("__bool__", "__float__", "__int__", "item", "tolist", "numpy")
ALLOWED = {"host_seeds"}  # the CPU draw of models/decoder.py


class HostRead(AssertionError):
    pass


def no_host_reads(mp):
    """Make every read of a tensor into Python raise HostRead, except in
    the functions named in ALLOWED."""
    for name in READS:
        real = getattr(torch.Tensor, name)

        def guarded(self, *args, _real=real, _name=name, **kwargs):
            caller = sys._getframe(1).f_code.co_name
            if caller not in ALLOWED:
                raise HostRead(f"Tensor.{_name} in {caller}")
            return _real(self, *args, **kwargs)

        mp.setattr(torch.Tensor, name, guarded)


def guarded_optimizer(make):
    """make_optimizer whose update runs under no_host_reads."""
    def make_guarded(*args, **kwargs):
        tx = make(*args, **kwargs)
        update = tx.update

        def guarded_update(*a, **k):
            with pytest.MonkeyPatch.context() as mp:
                no_host_reads(mp)
                return update(*a, **k)

        tx.update = guarded_update
        return tx
    return make_guarded


@pytest.fixture
def guarded(monkeypatch):
    monkeypatch.setattr(train, "make_optimizer",
                        guarded_optimizer(train.make_optimizer))


def test_guard_catches_a_read():
    with pytest.MonkeyPatch.context() as mp:
        no_host_reads(mp)
        with pytest.raises(HostRead):
            bool(torch.ones(()) > 0)


@pytest.mark.parametrize("case", ["nan_at_step_2", "101st_in_a_row"])
def test_skip_nonfinite_on_device_matches_apply_if_finite(guarded, case):
    n = train.MAX_CONSECUTIVE_ERRORS + 1
    if case == "nan_at_step_2":
        seq = optim_tests._grad_sequence(4, 6, (10.0,), nonfinite_steps=(2,))
        nonfinite = 1
    else:
        seq = optim_tests._grad_sequence(
            2, n + 2, (1.0,), nonfinite_steps=range(1, n + 1))
        nonfinite = n
    init, history, jcount, state = optim_tests._run_both(
        {"SKIP_NONFINITE": True, "WARMUP_EPOCHS": 0.5}, seq)
    for step, (want, got) in enumerate(history):
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {step}")
    for counter in (state.count, state.notfinite_count,
                    state.total_notfinite):
        assert isinstance(counter, torch.Tensor) and counter.dim() == 0
    assert int(state.total_notfinite) == jcount == nonfinite
    if case == "nan_at_step_2":
        # step 2 changed nothing: the parameters after it are those after
        # step 1, and Adam's count skipped it
        for before, after in zip(history[1][1], history[2][1]):
            np.testing.assert_array_equal(before, after)
        assert int(state.count) == len(seq) - 1
        assert int(state.notfinite_count) == 0
    else:
        # the 101st non-finite step in a row is applied (Adam's count 2),
        # the next, finite, one too and resets the run
        assert not np.isfinite(history[n][1][2]).all()
        assert int(state.count) == 3
        assert int(state.notfinite_count) == 0


def toy_train_cfg():
    cfg = load_config("configs/synthetic_ap_ablation.yaml")
    cfg.NETWORK.IMAGE_SIZE = [96, 64]
    cfg.DECODER.d_model = 32
    cfg.DECODER.dim_feedforward = 64
    cfg.DECODER.nhead = 4
    cfg.DECODER.dec_n_points = 2
    cfg.DECODER.num_decoder_layers = 2
    cfg.DECODER.num_instance = 16
    cfg.POSE_RESNET.NUM_DECONV_FILTERS = [32, 32, 32]
    cfg.DATASET.CAMERA_NUM = 3
    cfg.MULTI_PERSON.MAX_PEOPLE_NUM = 4
    cfg.PARALLEL.COMPUTE_DTYPE = "float32"
    return cfg


def test_dq_training_step_reads_nothing_back(guarded):
    cfg = toy_train_cfg()
    assert cfg.DECODER.match_method == "KNN" and cfg.DECODER.dropout > 0
    assert cfg.TRAIN.SKIP_NONFINITE and cfg.PARALLEL.REMAT_DECODER
    model = MVGFormer(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    batch = make_batch(cfg, seed=2, num_people=2, device="cpu")
    state, tx = train.create_train_state(cfg, model)
    step = train.make_train_step(cfg, model, tx)
    generator = torch.Generator().manual_seed(1)
    for _ in range(2):
        with pytest.MonkeyPatch.context() as mp:
            no_host_reads(mp)
            state, metrics = step(state, batch, generator)
    assert state.step == 2 and int(state.opt_state.count) == 2
    assert isinstance(metrics["notfinite_total"], torch.Tensor)
    assert all(torch.isfinite(v).all() for v in metrics.values())
