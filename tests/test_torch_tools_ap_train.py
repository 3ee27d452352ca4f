"""The port's fast trainer (mvgformer_tpu_torch/tools/ap_train_fast.py)
against the JAX package's loop (tools/ap_train_fast.py) on the CPU.

Both run configs/synthetic_ap_ablation.yaml's training recipe (Jacobi DLT,
TRAIN_BACKBONE, TRI_GRAD_CLIP, SKIP_NONFINITE, clamp_refs_to_space, warmup)
at tools/make_golden.py's toy widths with dropout 0 (the two frameworks'
dropout generators cannot agree), on 3 synthetic frames for 2 epochs, the
port starting from JAX's initial weights carried across by
port_state_dict_from_jax:

  * the same frames in the same order (the shuffle of TRAIN.SEED + epoch);
  * each epoch's metric line, every key but wall_s, within rtol 1e-4;
  * the clipped gradients of the two steps taken before any parameter
    moves (the warmup's rate is 0 at step 0, so step 1 runs at the
    initial weights too), read from each side's Adam first moments:
    every leaf within 1e-3 of its largest, except a backbone leaf that
    JAX's own float32 gradient does not resolve, i.e. lies further than
    1e-3 of its largest from the float64 gradient (the port's backbone in
    float64 on the step's images and backbone cotangent, clipped by the
    port's factor). Those leaves are printed with their readings, and the
    port's gradient must lie no further from the float64 one than JAX's.
    They are BatchNorm biases of the first two stages, sums over every
    position that cancel to float32 noise: JAX misses float64 there by
    3.5-19% of the leaf's largest, the port by 1.5-13.5%;
  * the final parameters: each leaf's update (final - initial) along
    JAX's (cosine >= 0.95), BatchNorm's statistics within 1e-3 of their
    largest. Elementwise 1e-3 is not sound after the first real update:
    Adam moves each element of the noise leaves by +-lr on the sign of
    its noise, and one step later the two frameworks' gradients differ by
    over 1e-3 of the leaf's largest on ~50 of 150 leaves (up to 20%), and
    the final parameters on most leaves. The metric lines above hold the
    trajectory;
  * the checkpoint: a run interrupted in its second epoch saves the end of
    the first (the snapshot, bit for bit, labelled to resume at epoch 1),
    not the partly run epoch; `resume` from it ends bit for bit where the
    straight run ended.

JAX's step runs as tests/test_torch_train_step.py runs it: Jacobi's solve
op by op on the host (`_jacobi_hosted`), so that no XLA compile of its
unrolled gradient is needed; its checkpoint writes are captured instead of
written.

The KNN gt match ranks L1 pose costs, which have exact ties (an L1 sum is
flat between joints), and each framework's float32 sum order breaks a tie
its own way: on frame 0 queries 11 and 14 both cost 660.5894 mm, JAX's
sum puts 14 one ulp below, the port's none, so the two would train on
different matched queries. Both sides' match costs are rounded to 1e-3
here, so a tie is a tie in both and both take the lower index (top-k's
order); the match itself is held to JAX's in the model tests.
"""

import json
import os
import sys

import jax
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import ap_train_fast as jax_fast  # noqa: E402

from mvgformer_tpu.core import train as jtrain  # noqa: E402
from mvgformer_tpu.geometry import triangulate as jtri  # noqa: E402
from mvgformer_tpu.models import matcher as jmatcher  # noqa: E402
from mvgformer_tpu.utils import checkpoint as jckpt  # noqa: E402
from mvgformer_tpu_torch import models as pmodels  # noqa: E402
from mvgformer_tpu_torch.config import load_config  # noqa: E402
from mvgformer_tpu_torch.core import criterion as pcriterion  # noqa: E402
from mvgformer_tpu_torch.core import train as ptrain  # noqa: E402
from mvgformer_tpu_torch.models import pose_resnet as ppose  # noqa: E402
from mvgformer_tpu_torch.tools import ap_train_fast  # noqa: E402
from mvgformer_tpu_torch.utils.jax_convert import port_state_dict_from_jax  # noqa: E402
from test_torch_train_step import _jacobi_hosted  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

TOY = ["NETWORK.IMAGE_SIZE=[96,64]", "DECODER.d_model=32",
       "DECODER.dim_feedforward=64", "DECODER.nhead=4",
       "DECODER.dec_n_points=2", "DECODER.num_decoder_layers=2",
       "DECODER.num_instance=16", "DECODER.dropout=0.0",
       "POSE_RESNET.NUM_DECONV_FILTERS=[32,32,32]", "DATASET.CAMERA_NUM=3",
       "MULTI_PERSON.MAX_PEOPLE_NUM=4", "PARALLEL.COMPUTE_DTYPE=float32",
       "DATASET.MAX_DATA_NUM=3", "TRAIN.END_EPOCH=2",
       "TRAIN.WARMUP_EPOCHS=1"]
FRAMES, EPOCHS = 3, 2
EARLY_STEPS = 2  # the steps at the initial weights (the warmup's rate is 0)


def rounded(cost_fn, round_fn):
    """The match cost rounded to 1e-3 (see the module docstring)."""
    def cost(*args, **kwargs):
        return round_fn(cost_fn(*args, **kwargs) * 1e3) / 1e3
    return cost


def frame_key(batch):
    """A frame's identity in either framework: the sum of its gt joints."""
    return float(np.asarray(batch.targets.joints_3d).sum())


def recording(make_step, order, after=None):
    """make_train_step wrapped so that each step records its frame (and
    calls after(step index, the step's new state) once it has run)."""
    def make(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def wrapped(state, batch, rng):
            order.append(frame_key(batch))
            out = step(state, batch, rng)
            if after is not None:
                after(len(order), out[0])
            return out
        return wrapped
    return make


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_fast")
    got = {"order": [], "saved": []}
    real_state = jtrain.create_train_state

    def create_state(*args, **kwargs):
        state, tx = real_state(*args, **kwargs)
        got["init"] = jax.tree_util.tree_map(np.asarray, {
            "params": state.params, "batch_stats": state.batch_stats})
        return state, tx

    def save(ckpt_dir, state, epoch, **kwargs):
        got["saved"].append((epoch, kwargs.get("next_epoch"),
                             jax.tree_util.tree_map(np.asarray, {
                                 "params": state.params,
                                 "batch_stats": state.batch_stats})))

    def after(n, state):
        if n <= EARLY_STEPS:
            got.setdefault("opt", []).append(state.opt_state)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmatcher, "pose_l1_cost",
                   rounded(jmatcher.pose_l1_cost, jax.numpy.round))
        mp.setattr(jtri, "jacobi4_smallest",
                   lambda G, sweeps=6: _jacobi_hosted(G))
        mp.setattr(jtrain, "create_train_state", create_state)
        mp.setattr(jtrain, "make_train_step",
                   recording(jtrain.make_train_step, got["order"], after))
        mp.setattr(jckpt, "save_checkpoint", save)
        mp.setattr(sys, "argv", ["ap_train_fast.py", "--out", str(out),
                                 *TOY])
        jax_fast.main()
    with open(out / "fast_train_metrics.jsonl") as f:
        got["lines"] = [json.loads(line) for line in f]
    return got


def round_costs(mp):
    mp.setattr(pcriterion, "pose_l1_cost",
               rounded(pcriterion.pose_l1_cost, torch.round))


def port_cfg(*extra):
    from mvgformer_tpu_torch.tools.ap_train_fast import CFG

    return load_config(CFG, TOY + list(extra))


@pytest.fixture(scope="module")
def port_run(jax_run, tmp_path_factory):
    """The port's straight 2-epoch run from JAX's initial weights; the
    parameters at the end of epoch 0 are kept."""
    cfg = port_cfg()
    weights = port_state_dict_from_jax(jax_run["init"], cfg)
    out = tmp_path_factory.mktemp("port_fast")
    order, got = [], {"early": [], "backbone_io": []}

    def after(n, state):
        model = holder["model"]
        if n <= EARLY_STEPS:
            io = got["backbone_io"][-1]
            got["early"].append({
                "grads": {k: p.grad.clone() for k, p in
                          model.named_parameters() if p.grad is not None},
                "mu": {k: v.clone() for k, v in state.opt_state.mu.items()},
                "images": io["images"], "levels": io["levels"],
                "cotangents": [f.grad.clone() for f in io["feats"]]})
        if n == FRAMES:
            got["epoch0"] = {k: v.detach().clone() for k, v in
                             model.state_dict().items()}

    holder = {}
    real_build = pmodels.build_model
    real_backbone = ppose.PoseResNet.forward

    def build(*args, **kwargs):
        holder["model"] = real_build(*args, **kwargs)
        return holder["model"]

    def backbone(self, x, use_feat_level=(0, 1, 2)):
        feats = real_backbone(self, x, use_feat_level)
        if len(got["early"]) < EARLY_STEPS and torch.is_grad_enabled():
            for f in feats:
                f.retain_grad()
            got["backbone_io"].append({"images": x.detach().clone(),
                                       "levels": tuple(use_feat_level),
                                       "feats": feats})
        return feats

    with pytest.MonkeyPatch.context() as mp:
        round_costs(mp)
        mp.setattr(ptrain, "make_train_step",
                   recording(ptrain.make_train_step, order, after))
        mp.setattr(pmodels, "build_model", build)
        mp.setattr(ppose.PoseResNet, "forward", backbone)
        result = ap_train_fast.train(cfg, str(out), "cpu",
                                     initial_weights=weights,
                                     log=lambda msg: None)
    return {"cfg": cfg, "weights": weights, "order": order,
            "result": result, "epoch0": got["epoch0"],
            "early": got["early"],
            "final": {k: v.detach().clone() for k, v in
                      holder["model"].state_dict().items()}}


def test_same_frame_order(jax_run, port_run):
    assert len(port_run["order"]) == FRAMES * EPOCHS
    np.testing.assert_allclose(port_run["order"], jax_run["order"],
                               rtol=1e-6)
    # each epoch visits every frame once
    for e in range(EPOCHS):
        epoch = port_run["order"][e * FRAMES:(e + 1) * FRAMES]
        assert len(set(epoch)) == FRAMES


@pytest.mark.parametrize("epoch", range(EPOCHS))
def test_epoch_lines_match_jax(jax_run, port_run, epoch):
    want = jax_run["lines"][epoch]
    got = port_run["result"]["epochs"][epoch]
    assert set(got) == set(want)
    for key in want:
        if key == "wall_s":
            continue
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-4, err_msg=key)


def jax_first_moments(opt_state, variables, cfg):
    """The first moments of JAX's Adam states (both groups), under the
    port's parameter names."""
    moments = {}

    def adam(node):
        if isinstance(node, optax.ScaleByAdamState):
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                    node.mu, is_leaf=lambda x: isinstance(
                        x, optax.MaskedNode))[0]:
                if not isinstance(leaf, optax.MaskedNode):
                    moments[path] = np.asarray(leaf)
            return True
        return False

    jax.tree_util.tree_map(lambda x: x, opt_state, is_leaf=adam)
    params = variables["params"]
    leaves = [moments.get(path, np.zeros_like(leaf)) for path, leaf in
              jax.tree_util.tree_flatten_with_path(params)[0]]
    tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params), leaves)
    return port_state_dict_from_jax(
        {"params": tree, "batch_stats": variables["batch_stats"]}, cfg)


def float64_backbone_grads(cfg, weights, images, levels, cotangents):
    """The port's backbone in float64 at `weights`: its parameters'
    gradient for the cotangents of its output `levels`."""
    model = pmodels.build_model(cfg, device="cpu")
    model.load_state_dict(weights)
    backbone = model.backbone.double()
    backbone.dtype = torch.float64
    feats = backbone(images.double(), levels)
    torch.autograd.backward(feats, [c.double() for c in cotangents])
    return {f"backbone.{k}": (torch.zeros_like(p) if p.grad is None
                              else p.grad)
            for k, p in backbone.named_parameters()}


@pytest.mark.parametrize("step", range(EARLY_STEPS))
def test_gradients_at_the_initial_weights_match_jax(jax_run, port_run,
                                                    step):
    cfg = port_run["cfg"]
    early = port_run["early"][step]
    b1 = ptrain.Optimizer.b1

    def clipped_gradient(mu):
        """The step's clipped gradient from the first moments after it
        and before it."""
        g = mu[step][name] - (b1 * mu[step - 1][name] if step else 0)
        return g.double() / (1 - b1)

    jmu = [jax_first_moments(o, jax_run["init"], cfg)
           for o in jax_run["opt"][:step + 1]]
    pmu = [e["mu"] for e in port_run["early"][:step + 1]]
    # the float64 gradient, clipped by the port's factor (the two
    # frameworks' norms agree far below 1e-3)
    norm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                for g in early["grads"].values())))
    clip = min(1.0, cfg.TRAIN.clip_max_norm / norm)
    exact = float64_backbone_grads(cfg, port_run["weights"],
                                   early["images"], early["levels"],
                                   early["cotangents"])
    held = noise = 0
    for name in pmu[step]:
        got, want = clipped_gradient(pmu), clipped_gradient(jmu)
        largest = float(want.abs().max())
        if name in exact:
            e = exact[name] * clip
            jax_gap = float((want - e).abs().max())
            if jax_gap > 1e-3 * float(e.abs().max()):
                port_gap = float((got - e).abs().max())
                print(f"step {step} {name}: float32 noise, largest "
                      f"{float(e.abs().max()):.3e}, JAX's gap to float64 "
                      f"{jax_gap:.3e}, the port's {port_gap:.3e}")
                assert port_gap <= jax_gap, (name, port_gap, jax_gap)
                noise += 1
                continue
        err = float((got - want).abs().max())
        assert err <= 1e-3 * largest + 1e-12, (name, err, largest)
        held += 1
    assert held > 100 and noise < 20, (held, noise)


def test_final_params_match_jax(jax_run, port_run):
    epoch, next_epoch, variables = jax_run["saved"][-1]
    assert (epoch, next_epoch) == (EPOCHS - 1, EPOCHS)
    cfg = port_run["cfg"]
    want = port_state_dict_from_jax(variables, cfg)
    got, init = port_run["final"], port_run["weights"]
    params = dict(port_run["early"][0]["mu"])
    checked = 0
    for name, w in want.items():
        if not torch.is_floating_point(w):
            continue
        if name not in params:  # a buffer: BatchNorm's running statistics
            diff = float((got[name] - w).abs().max())
            assert diff <= 1e-3 * float(w.abs().max()) + 1e-7, (name, diff)
            continue
        moved_jax = (w - init[name]).flatten()
        moved = (got[name] - init[name]).flatten()
        if float(moved_jax.abs().max()) > 0:
            cos = float(torch.nn.functional.cosine_similarity(
                moved, moved_jax, dim=0))
            assert cos >= 0.95, (name, cos)
        checked += 1
    assert checked > 50


def test_interrupt_saves_last_whole_epoch_and_resume_ends_equal(
        port_run, tmp_path):
    """A run stopped after the first step of epoch 1 saves the end of
    epoch 0 from its snapshot; resuming from it reproduces the straight
    run bit for bit."""
    cfg = port_cfg()
    out = str(tmp_path)

    def stop(n, state):
        if n == FRAMES + 1:
            raise KeyboardInterrupt

    with pytest.MonkeyPatch.context() as mp:
        round_costs(mp)
        mp.setattr(ptrain, "make_train_step",
                   recording(ptrain.make_train_step, [], stop))
        with pytest.raises(KeyboardInterrupt):
            ap_train_fast.train(cfg, out, "cpu",
                                initial_weights=port_run["weights"],
                                log=lambda msg: None)
    ckpt_dir = os.path.join(out, "checkpoints")
    payload = torch.load(os.path.join(ckpt_dir, "0.pt"), weights_only=True)
    assert payload["meta"]["epoch"] == 1
    assert payload["step"] == FRAMES
    assert payload["opt_state"]["count"] == FRAMES
    for name, want in port_run["epoch0"].items():
        assert torch.equal(payload["model"][name], want), name
    with open(os.path.join(out, ap_train_fast.METRICS_FILE)) as f:
        assert [json.loads(line)["epoch"] for line in f] == [0]

    with pytest.MonkeyPatch.context() as mp:
        round_costs(mp)
        resumed = ap_train_fast.train(cfg, out, "cpu", resume=True,
                                      log=lambda msg: None)
    assert (resumed["start_epoch"], resumed["last_epoch"]) == (1, 1)
    payload = torch.load(os.path.join(ckpt_dir, "1.pt"), weights_only=True)
    for name, want in port_run["final"].items():
        assert torch.equal(payload["model"][name], want), name
    assert resumed["epochs"][0] == {
        **port_run["result"]["epochs"][1],
        "wall_s": resumed["epochs"][0]["wall_s"]}
