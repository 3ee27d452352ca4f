"""The port's optimizer and training switches, apart from the model where
the JAX package can be run the same way:

  * make_lr_schedule against JAX's optax schedules step by step (multistep,
    cosine, each with and without the linear warmup): rtol 1e-6 and atol
    1e-6 * LR (optax computes the rate in float32, the port in float64;
    near the cosine's end 1 + cos(pi t) cancels to a few ulps of 1);
  * the clipped two-group Adam against JAX's make_optimizer on a small
    parameter tree with the model's naming rules (frozen backbone, 'proj'
    names, 'main'), over steps whose gradient norm is above and below the
    clip, with clipping off, and under TRAIN.SKIP_NONFINITE with a
    non-finite step: parameters at rtol 1e-5 (float32 Adam arithmetic in
    another order), the non-finite count equal;
  * SKIP_NONFINITE's limit: 100 non-finite steps in a row are dropped, the
    101st is applied, as optax.apply_if_finite(max_consecutive_errors=100);
  * the 'proj' group moves at DECODER.lr_linear_proj_mult times the 'main'
    group's rate;
  * clip_cotangent against JAX's: the forward exact, the clipped
    cotangent at float32 rtol 1e-6;
  * dropout: active only in the training forward; under
    PARALLEL.REMAT_DECODER the recomputed layers draw the same masks, so
    the gradients with and without remat are equal at dropout 0.1 for one
    generator seed (the same float32 ops in the same order: bitwise);
  * TRAIN.SAMPLE_CHUNKS and PARALLEL.REMAT_POLICY 'save_sampled' give
    JAX's losses; SAMPLE_CHUNKS off (None, 0, 1) builds.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mvgformer_tpu.config import load_config as jax_load_config
from mvgformer_tpu.core import train as jtrain
from mvgformer_tpu.geometry.triangulate import clip_cotangent as jclip
from mvgformer_tpu_torch.config import load_config
from mvgformer_tpu_torch.core import train
from mvgformer_tpu_torch.data.synthetic import make_batch
from mvgformer_tpu_torch.geometry.triangulate import clip_cotangent
from mvgformer_tpu_torch.models.mvgformer import MVGFormer
from torch_parity import check_train_step, make_case

STEPS_PER_EPOCH = 4

SCHEDULES = {
    "multistep": {"LR_STEP": [2, 3], "END_EPOCH": 5},
    "cosine": {"LR_SCHEDULER": "cosine", "END_EPOCH": 5},
    "warmup_multistep": {"LR_STEP": [2, 3], "END_EPOCH": 5,
                         "WARMUP_EPOCHS": 0.75},
    "warmup_cosine": {"LR_SCHEDULER": "cosine", "END_EPOCH": 5,
                      "WARMUP_EPOCHS": 1.5},
}


def _cfgs(train_overrides=(), **dec_overrides):
    """The JAX package's config and the port's, with the same overrides."""
    out = []
    for load in (jax_load_config, load_config):
        cfg = load()
        for key, val in dict(train_overrides).items():
            setattr(cfg.TRAIN, key, val)
        for key, val in dec_overrides.items():
            setattr(cfg.DECODER, key, val)
        out.append(cfg)
    return out


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_lr_schedule_matches_jax(case):
    jcfg, cfg = _cfgs(SCHEDULES[case])
    want = jtrain.make_lr_schedule(jcfg, STEPS_PER_EPOCH)
    got = train.make_lr_schedule(cfg, STEPS_PER_EPOCH)
    steps = range(cfg.TRAIN.END_EPOCH * STEPS_PER_EPOCH + 3)
    np.testing.assert_allclose([got(s) for s in steps],
                               [float(want(s)) for s in steps],
                               rtol=1e-6, atol=1e-6 * cfg.TRAIN.LR)


# (JAX tree path, the port's parameter name, shape)
LEAVES = (
    (("backbone", "conv1", "kernel"), "backbone.conv1.weight", (3, 2)),
    (("decoder", "layer_0", "proj_attn", "sampling_offsets", "kernel"),
     "decoder.layers.0.proj_attn.sampling_offsets.weight", (4, 3)),
    (("decoder", "layer_0", "proj_attn", "sampling_offsets", "bias"),
     "decoder.layers.0.proj_attn.sampling_offsets.bias", (3,)),
    (("decoder", "layer_0", "proj_attn", "attention_weights", "kernel"),
     "decoder.layers.0.proj_attn.attention_weights.weight", (4, 5)),
    (("reference_points", "kernel"), "reference_points.weight", (2, 3)),
    (("decoder", "layer_0", "linear1", "bias"),
     "decoder.layers.0.linear1.bias", (6,)),
)


def _tree(arrays):
    tree = {}
    for (path, _, _), a in zip(LEAVES, arrays):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = jnp.asarray(a)
    return tree


def _leaves(tree):
    out = []
    for path, _, _ in LEAVES:
        node = tree
        for key in path:
            node = node[key]
        out.append(np.asarray(node))
    return out


def _grad_sequence(seed, n, scales, nonfinite_steps=()):
    rng = np.random.RandomState(seed)
    seq = []
    for i in range(n):
        grads = [(rng.randn(*shape) * scales[i % len(scales)]).astype(
            np.float32) for _, _, shape in LEAVES]
        if i in nonfinite_steps:
            grads[2][0] = np.nan if i % 2 else np.inf
        seq.append(grads)
    return seq


def _run_both(train_overrides, grad_seq, steps_per_epoch=STEPS_PER_EPOCH):
    """The same gradient sequence through optax and the port; the
    parameters after every step, and the final non-finite counts."""
    jcfg, cfg = _cfgs(train_overrides, lr_linear_proj_mult=0.1)
    rng = np.random.RandomState(0)
    init = [rng.randn(*shape).astype(np.float32) for _, _, shape in LEAVES]

    jtx = jtrain.make_optimizer(jcfg, steps_per_epoch)
    jparams = _tree(init)
    jstate = jtx.init(jparams)
    jupdate = jax.jit(jtx.update)

    tx = train.make_optimizer(cfg, steps_per_epoch)
    params = {name: torch.from_numpy(a.copy())
              for (_, name, _), a in zip(LEAVES, init)}
    state = tx.init(params)

    history = []
    for grads in grad_seq:
        updates, jstate = jupdate(_tree(grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        updates, state = tx.update(
            {name: torch.from_numpy(g) for (_, name, _), g in
             zip(LEAVES, grads)}, state, params)
        for name, u in updates.items():
            if u is not None:
                params[name] = params[name] + u
        history.append((_leaves(jparams),
                        [params[name].numpy() for _, name, _ in LEAVES]))
    jcount = (int(jstate.total_notfinite) if hasattr(
        jstate, "total_notfinite") else 0)
    return init, history, jcount, state


OPTIM_CASES = {
    # gradient norms ~2e-2 and ~20 around the 0.1 clip
    "clip": ({}, (0.01, 10.0, 0.01, 10.0)),
    "no_clip": ({"clip_max_norm": 0.0}, (0.01, 10.0)),
    "skip_nonfinite": ({"SKIP_NONFINITE": True, "WARMUP_EPOCHS": 0.5},
                       (10.0,)),
    "warmup_cosine_epochs": ({"LR_SCHEDULER": "cosine", "END_EPOCH": 2,
                              "WARMUP_EPOCHS": 0.75}, (1.0,)),
}


@pytest.mark.parametrize("case", list(OPTIM_CASES))
def test_optimizer_matches_optax(case):
    overrides, scales = OPTIM_CASES[case]
    nonfinite = (2, 5) if overrides.get("SKIP_NONFINITE") else ()
    init, history, jcount, state = _run_both(
        overrides, _grad_sequence(1, 10, scales, nonfinite))
    for step, (want, got) in enumerate(history):
        for (_, name, _), w, g in zip(LEAVES, want, got):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name} after step {step}")
    # the frozen backbone never moves
    np.testing.assert_array_equal(history[-1][1][0], init[0])
    assert state.total_notfinite == jcount == len(nonfinite)
    assert state.count == len(history) - len(nonfinite)


def test_skip_nonfinite_applies_the_101st_in_a_row():
    n = train.MAX_CONSECUTIVE_ERRORS + 1
    seq = _grad_sequence(2, n + 1, (1.0,), nonfinite_steps=range(1, n + 1))
    init, history, jcount, state = _run_both({"SKIP_NONFINITE": True}, seq)
    for want, got in history[:n]:
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)
            assert np.isfinite(g).all()
    # step n + 1 is the 101st non-finite one in a row: applied
    last_want, last_got = history[n]
    assert not np.isfinite(last_want[2]).all()
    assert not np.isfinite(last_got[2]).all()
    assert state.total_notfinite == jcount == n
    assert state.notfinite_count == n


def test_proj_group_moves_at_the_mult_rate():
    cfg = load_config()
    cfg.DECODER.lr_linear_proj_mult = 0.25
    tx = train.make_optimizer(cfg, STEPS_PER_EPOCH)
    g = torch.from_numpy(np.random.RandomState(3).randn(5).astype(
        np.float32)) * 1e-3  # under the clip
    names = ("decoder.layers.0.linear1.bias",
             "decoder.layers.0.proj_attn.sampling_offsets.bias",
             "reference_points.bias", "backbone.bn1.bias")
    params = {k: torch.zeros(5) for k in names}
    state = tx.init(params)
    for _ in range(3):
        updates, state = tx.update({k: g for k in names}, state, params)
        main = updates[names[0]]
        assert main.abs().min() > 0
        for proj in names[1:3]:
            np.testing.assert_allclose(updates[proj].numpy(),
                                       0.25 * main.numpy(), rtol=1e-6)
        assert updates[names[3]] is None


@pytest.mark.parametrize("max_norm", [0.5, 3.0])
def test_clip_cotangent_matches_jax(max_norm):
    rng = np.random.RandomState(4)
    x = rng.randn(6, 5, 2).astype(np.float32)
    ct = (rng.randn(6, 5, 2) * rng.rand(6, 5, 1) * 4).astype(np.float32)
    out, vjp = jax.vjp(lambda v: jclip(v, max_norm), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = clip_cotangent(tx, max_norm)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    np.testing.assert_array_equal(got.detach().numpy(), x)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(vjp(
        jnp.asarray(ct))[0]), rtol=1e-6, atol=0)
    norms = np.linalg.norm(tx.grad.numpy(), axis=-1)
    assert norms.max() <= max_norm * (1 + 1e-6)


def _toy_cfg(dropout=0.1):
    cfg = load_config()
    cfg.NETWORK.IMAGE_SIZE = [96, 64]
    cfg.DECODER.d_model = 32
    cfg.DECODER.dim_feedforward = 64
    cfg.DECODER.nhead = 4
    cfg.DECODER.dec_n_points = 2
    cfg.DECODER.num_decoder_layers = 2
    cfg.DECODER.num_instance = 16
    cfg.DECODER.triangulation_method = "jacobi"
    cfg.DECODER.dropout = dropout
    cfg.POSE_RESNET.NUM_LAYERS = 18
    cfg.POSE_RESNET.NUM_DECONV_FILTERS = [32, 32, 32]
    cfg.DATASET.CAMERA_NUM = 3
    cfg.MULTI_PERSON.MAX_PEOPLE_NUM = 4
    cfg.PARALLEL.COMPUTE_DTYPE = "float32"
    return cfg


@pytest.fixture(scope="module")
def toy():
    cfg = _toy_cfg()
    model = MVGFormer(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    cfg0 = _toy_cfg(dropout=0.0)
    model0 = MVGFormer(cfg0, device="cpu")
    model0.load_state_dict(model.state_dict())
    batch = make_batch(cfg, seed=2, num_people=2, device="cpu")
    mask = torch.zeros(1, cfg.DECODER.num_instance, dtype=torch.bool)
    mask[0, :5] = True
    return cfg, model, model0, batch, mask


def _train_forward(model, batch, mask, seed):
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    with torch.no_grad():
        return model(batch, query_mask=mask, train=True, generator=gen)


def test_dropout_only_in_training(toy):
    cfg, model, model0, batch, mask = toy
    # serving: dropout 0.1 and 0.0 give the same outputs
    with torch.no_grad():
        for a, b in zip(model(batch, threshold=0.1),
                        model0(batch, threshold=0.1)):
            for key in a:
                torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    # training: the masks follow the generator's seed
    base = _train_forward(model0, batch, mask, None)
    one = _train_forward(model, batch, mask, 1)
    again = _train_forward(model, batch, mask, 1)
    other = _train_forward(model, batch, mask, 2)
    hs = [o[0]["pred_logits"] for o in (base, one, again, other)]
    torch.testing.assert_close(hs[1], hs[2], rtol=0, atol=0)
    assert not torch.equal(hs[0], hs[1])
    assert not torch.equal(hs[1], hs[3])


def test_remat_reproduces_dropout(toy):
    cfg, model, _, batch, _ = toy
    grads = []
    for remat in (True, False):
        m = copy.deepcopy(model)
        m.decoder.remat = remat
        state, tx = train.create_train_state(cfg, m)
        _, metrics = train.make_train_step(cfg, m, tx)(
            state, batch, torch.Generator().manual_seed(7))
        grads.append({k: p.grad for k, p in m.named_parameters()
                      if p.grad is not None})
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) > 50
    for k in grads[0]:
        torch.testing.assert_close(grads[0][k], grads[1][k], rtol=0,
                                   atol=0, msg=k)


@pytest.mark.parametrize("section,key,value", [
    ("TRAIN", "SAMPLE_CHUNKS", 2),
    ("PARALLEL", "REMAT_POLICY", "save_sampled"),
])
def test_unported_training_options_raise(section, key, value):
    """Once refused here (hence the name), now run: a make_train_step with
    the option on, on the toy config of tests/torch_parity.py, against the
    losses of JAX's training forward and criterion with the same option
    (rtol 1e-4)."""
    case = make_case(f"{section}.{key}", {f"{section}.{key}": value})
    assert getattr(getattr(case["cfg"], section), key) == value
    check_train_step(case)


@pytest.mark.parametrize("chunks", [None, 0, 1])
def test_sample_chunks_off_is_accepted(chunks):
    cfg = _toy_cfg()
    cfg.TRAIN.SAMPLE_CHUNKS = chunks
    MVGFormer(cfg, device="cpu")
