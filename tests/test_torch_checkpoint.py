"""The port's checkpoints (utils/checkpoint.py, torch.save) and its loaders
of the original torch repo's files (utils/torch_convert.py,
load_backbone_pretrained), on the toy config of
tests/test_torch_train_step.py (dropout 0):

  * save / load round trip, bit for bit: weights, buffers, Adam's count,
    mu and nu, the apply-if-finite counters, the step, the meta;
  * the latest 3 steps kept, `best/` keeping 1, a re-save replacing its
    step; every file read with torch.load(..., weights_only=True);
  * resume: 2 steps, save, a fresh model resumed from the file, 1 step ==
    3 straight steps, bit for bit;
  * load_backbone_pretrained and convert_mvgformer_state_dict against the
    JAX package's (its converters, then port_state_dict_from_jax), on
    random tensors under the original repo's names.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import make_golden  # noqa: E402

from mvgformer_tpu.utils import checkpoint as jckpt  # noqa: E402
from mvgformer_tpu.utils import torch_convert as jconvert  # noqa: E402
from mvgformer_tpu_torch.core import train  # noqa: E402
from mvgformer_tpu_torch.data.synthetic import make_batch  # noqa: E402
from mvgformer_tpu_torch.models.mvgformer import MVGFormer  # noqa: E402
from mvgformer_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from mvgformer_tpu_torch.utils.jax_convert import port_state_dict_from_jax  # noqa: E402
from mvgformer_tpu_torch.utils.torch_convert import (  # noqa: E402
    convert_mvgformer_state_dict, load_torch_checkpoint)
from torch_one_thread import one_torch_thread  # noqa: E402,F401

def _cfg():
    cfg = make_golden.toy_cfg(topk=None, solver="jacobi")
    cfg.POSE_RESNET.NUM_LAYERS = 18
    cfg.DECODER.dropout = 0.0
    cfg.TRAIN.SKIP_NONFINITE = True
    return cfg


def _model(cfg, seed):
    return MVGFormer(cfg, generator=torch.Generator().manual_seed(seed),
                     device="cpu")


def _batches(cfg, n):
    return [make_batch(cfg, seed=20 + i, num_people=2, device="cpu")
            for i in range(n)]


def _steps(cfg, state, tx, batches):
    step = train.make_train_step(cfg, state.model, tx)
    for b in batches:
        state, _ = step(state, b, torch.Generator().manual_seed(0))
    return state


def _assert_states_equal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.opt_state, b.opt_state
    assert (oa.count, oa.notfinite_count, oa.total_notfinite) == (
        ob.count, ob.notfinite_count, ob.total_notfinite)
    for moments in ("mu", "nu"):
        ma, mb = getattr(oa, moments), getattr(ob, moments)
        assert set(ma) == set(mb) and len(ma) > 0
        for k in ma:
            assert torch.equal(ma[k], mb[k]), (moments, k)
    assert a.step == b.step


@pytest.fixture(scope="module")
def trained():
    cfg = _cfg()
    state, tx = train.create_train_state(cfg, _model(cfg, 0))
    state = _steps(cfg, state, tx, _batches(cfg, 2))
    return cfg, state, tx


def test_round_trip_bit_for_bit(trained, tmp_path):
    cfg, state, _ = trained
    state.opt_state.total_notfinite = 3  # a counter that must survive
    ckpt.save_checkpoint(str(tmp_path), state, epoch=4, precision=0.25,
                         is_best=True, next_epoch=5)
    fresh, _ = train.create_train_state(cfg, _model(cfg, 1))
    restored, next_epoch, precision = ckpt.load_checkpoint(str(tmp_path),
                                                           fresh)
    assert (next_epoch, precision) == (5, 0.25)
    _assert_states_equal(restored, state)
    sd, epoch = ckpt.load_params_checkpoint(str(tmp_path))
    assert epoch == 5 and set(sd) == set(state.model.state_dict())
    state.opt_state.total_notfinite = 0


def test_keep_three_best_one_and_weights_only(trained, tmp_path):
    _, state, _ = trained
    d = str(tmp_path)
    for epoch in range(5):
        ckpt.save_checkpoint(d, state, epoch, precision=epoch / 10,
                             is_best=epoch in (1, 3), next_epoch=epoch + 1)
    assert ckpt.all_steps(d) == [2, 3, 4]
    assert ckpt.all_steps(os.path.join(d, "best")) == [3]
    # saving over an existing step replaces it
    ckpt.save_checkpoint(d, state, 4, precision=0.9, next_epoch=4)
    assert ckpt.all_steps(d) == [2, 3, 4]
    assert ckpt.load_params_checkpoint(d)[1] == 4
    assert ckpt.load_params_checkpoint(d, step=3)[1] == 4
    assert ckpt.load_params_checkpoint(d, step=7) is None
    assert ckpt.load_params_checkpoint(str(tmp_path / "none")) is None
    for path in [os.path.join(d, f"{s}.pt") for s in (2, 3, 4)] + [
            os.path.join(d, "best", "3.pt")]:
        payload = torch.load(path, weights_only=True)
        assert set(payload) == {"model", "opt_state", "step", "meta"}
        assert set(payload["opt_state"]) == {
            "count", "mu", "nu", "notfinite_count", "total_notfinite"}


def test_resume_equals_straight_steps(tmp_path):
    cfg = _cfg()
    batches = _batches(cfg, 3)
    straight, tx = train.create_train_state(cfg, _model(cfg, 0))
    straight = _steps(cfg, straight, tx, batches)

    first, tx = train.create_train_state(cfg, _model(cfg, 0))
    first = _steps(cfg, first, tx, batches[:2])
    ckpt.save_checkpoint(str(tmp_path), first, epoch=0, next_epoch=1)
    resumed, tx = train.create_train_state(cfg, _model(cfg, 5))
    resumed, next_epoch, _ = ckpt.load_checkpoint(str(tmp_path), resumed)
    assert next_epoch == 1 and resumed.step == 2
    resumed = _steps(cfg, resumed, tx, batches[2:])
    _assert_states_equal(resumed, straight)


def _original_names_dict(cfg, rng):
    """Random tensors under the original repo's names: the port's own keys
    (it keeps them) behind 'module.', plus what the original model holds
    and the port drops."""
    model = _model(cfg, 0)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd["module." + k] = torch.tensor(int(rng.randint(1, 1000)))
        else:
            sd["module." + k] = torch.from_numpy(
                rng.randn(*v.shape).astype(np.float32))
    C = cfg.DECODER.d_model
    for extra, shape in (("pose_embed.0.MLP.layers.0.weight", (C, C)),
                         ("class_embed.0.weight", (2, C)),
                         ("reference_points.weight", (3, C)),
                         ("level_embed", (3, C)),
                         ("decoder.layers.0.self_attn.in_proj_weight",
                          (3 * C, C)),
                         ("backbone.final_layer.weight", (15, 32, 1, 1))):
        sd["module." + extra] = torch.from_numpy(
            rng.randn(*shape).astype(np.float32))
    return model, sd


def test_convert_matches_jax(tmp_path):
    # the JAX package's PoseResNet converter reads the ResNet-50 trunk
    cfg = _cfg()
    cfg.POSE_RESNET.NUM_LAYERS = 50
    model, sd = _original_names_dict(cfg, np.random.RandomState(0))
    want = port_state_dict_from_jax(
        jconvert.convert_mvgformer_state_dict(sd, cfg), cfg)
    got = convert_mvgformer_state_dict(sd, cfg)
    assert set(got) == set(want) == set(model.state_dict())
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    model.load_state_dict(got)
    path = str(tmp_path / "model.pth.tar")
    torch.save({"state_dict": sd}, path)
    from_file = load_torch_checkpoint(path, cfg)
    assert all(torch.equal(from_file[k], got[k]) for k in got)


def test_load_backbone_pretrained_matches_jax(tmp_path):
    # the JAX package's PoseResNet converter reads the ResNet-50 trunk
    cfg = _cfg()
    cfg.POSE_RESNET.NUM_LAYERS = 50
    model, sd = _original_names_dict(cfg, np.random.RandomState(1))
    backbone = {k[len("module.backbone."):]: v for k, v in sd.items()
                if k.startswith("module.backbone.")}
    path = str(tmp_path / "pose_resnet_50.pth.tar")
    torch.save({"state_dict": backbone}, path)

    base = model.state_dict()
    variables = jconvert.convert_mvgformer_state_dict(base, cfg)
    want = port_state_dict_from_jax(
        jckpt.load_backbone_pretrained(path, variables), cfg)
    got = ckpt.load_backbone_pretrained(path, base)
    assert set(got) == set(base)
    changed = 0
    for k in base:
        if k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], base[k]), k
            continue
        assert torch.equal(got[k], want[k]), k
        changed += not torch.equal(got[k], base[k])
    assert changed == sum(1 for k in base if k.startswith("backbone.")
                          and not k.endswith("num_batches_tracked"))
