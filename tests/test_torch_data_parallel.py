"""Data parallelism in the port (mvgformer_tpu_torch/parallel/) against
JAX's data-parallel mesh, on the toy DQ config (tests/torch_parity.py:
tools/make_golden.py's widths, ResNet-18, eigh DLT, dropout 0):

  * 2 gloo CPU ranks started by `parallel.launch` (the worker in
    tests/torch_dp_worker.py imports only the port) each take their 2 rows
    of a global batch of 4 frames and one `make_train_step(..., dp=)`;
    JAX takes the same 4 frames placed by `make_mesh(2)` + `shard_batch`
    on 2 of the 8 virtual CPU devices through the loss of its
    `make_train_step(num_replicas=2)` (the training forward with the gt
    match, `compute_losses`) and its gradient, as tests/test_train.py's
    mesh test does. Every loss term at rtol 1e-4 (the mean over the ranks
    of the port's), every trainable gradient within 1e-3 of its leaf's
    largest; the two ranks' gradients and their parameters after the Adam
    step equal bit for bit; and the 2-rank step against the port's own
    1-process step on the 4 frames, within the same classes. Both sides
    take the port's gt match: on the symmetric initial query grid two
    queries often have the same L1 cost to a person in exact arithmetic,
    and float32 rounds the two frameworks' sums apart, so KNN's
    lowest-index-first rule can pick other queries in JAX (the match is
    held against JAX in tests/test_torch_train_matcher.py);
  * the same where rank 1's frames hold no person: the criterion's
    sample count is the ranks' mean, clamped at 1 (a per-rank count
    would halve the gradient here);
  * `shard_batch`'s rows equal the rows JAX's places on each device, and
    a Batch field it has no rule for raises;
  * the backend rule and PARALLEL.DATA's world.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker
from mvgformer_tpu.core import criterion as jcrit
from mvgformer_tpu.data.synthetic import make_batch as jax_make_batch
from mvgformer_tpu.models.matcher import MatchResult as JMatchResult
from mvgformer_tpu.models.mvgformer import MVGFormer as JMVGFormer
from mvgformer_tpu.parallel import make_mesh
from mvgformer_tpu.parallel import shard_batch as jax_shard_batch
from mvgformer_tpu_torch.core import criterion as pcrit
from mvgformer_tpu_torch.core import train
from mvgformer_tpu_torch.data.meta import Batch
from mvgformer_tpu_torch.data.synthetic import batch_from_jax
from mvgformer_tpu_torch.parallel import (DataParallel, choose_backend,
                                          data_world, launch, shard_batch)
from torch_one_thread import one_torch_thread  # noqa: F401
from torch_parity import port_grads, port_model, toy_cfg

GLOBAL_BATCH, RANKS = 4, 2
LOSS_KEYS = ("total", "loss_ce", "loss_pose_perjoint",
             "loss_pose_perprojection_2d", "loss_init")


def _batches(cfg):
    jb = jax_make_batch(cfg, batch_size=GLOBAL_BATCH, seed=3, num_people=2)
    # rank 1's rows (frames 2 and 3) hold no person
    n = np.asarray(jb.targets.num_person).copy()
    n[GLOBAL_BATCH // RANKS:] = 0
    empty = jb.replace(targets=jb.targets.replace(num_person=jnp.asarray(n)))
    return {"people": jb, "rank1_empty": empty}


def _jax_losses_and_grads(cfg, jm):
    """The loss of JAX's make_train_step(num_replicas=RANKS) and its
    gradient, the gt match an argument."""
    def loss_fn(params, batch_stats, batch, match, init_refs):
        outs = jm.apply({"params": params, "batch_stats": batch_stats},
                        batch, query_mask=match.query_mask, train=True,
                        rngs={"dropout": jax.random.PRNGKey(1)})
        losses = jcrit.compute_losses(cfg, outs, batch, match,
                                      init_reference=init_refs,
                                      num_replicas=RANKS)
        return losses["total"], losses

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cfg = toy_cfg()
    jm = JMVGFormer(cfg=cfg)
    jbatches = _batches(cfg)
    variables = jax.jit(jm.init)(
        {"params": jax.random.PRNGKey(0), "init_ref": jax.random.PRNGKey(2)},
        jbatches["people"])
    variables = jax.tree_util.tree_map(
        np.asarray, {k: variables[k] for k in ("params", "batch_stats")})
    model = port_model(cfg, variables)
    batches = {case: batch_from_jax(jb) for case, jb in jbatches.items()}

    step = _jax_losses_and_grads(cfg, jm)
    init_refs = jm.initial_reference_points_static(GLOBAL_BATCH)
    mesh = make_mesh(RANKS)
    jax_out = {}
    for case, jb in jbatches.items():
        m = pcrit.match_queries(
            cfg, model.initial_reference_points_static(GLOBAL_BATCH),
            batches[case])
        match = JMatchResult(query_idx=jnp.asarray(m.query_idx.numpy()),
                             gt_valid=jnp.asarray(m.gt_valid.numpy()),
                             query_mask=jnp.asarray(m.query_mask.numpy()))
        (_, losses), grads = step(variables["params"],
                                  variables["batch_stats"],
                                  jax_shard_batch(jb, mesh), match, init_refs)
        jax_out[case] = ({k: float(v) for k, v in losses.items()},
                         jax.tree_util.tree_map(np.asarray, grads))

    state_dict = {k: v.clone() for k, v in model.state_dict().items()}
    out = tmp_path_factory.mktemp("dp")
    info = launch(torch_dp_worker.train_one_step, RANKS, "cpu",
                  dataclasses.asdict(cfg), state_dict, batches, str(out))
    ranks = {case: [dict(np.load(out / f"{case}-rank{r}.npz"))
                    for r in range(RANKS)] for case in batches}

    # the port's own 1-process step on the 4 frames
    single = {}
    for case, batch in batches.items():
        model.load_state_dict(state_dict)
        st, ptx = train.create_train_state(cfg, model)
        _, metrics = train.make_train_step(cfg, model, ptx)(st, batch)
        single[case] = ({k: float(v) for k, v in metrics.items()},
                        {k: None if p.grad is None else p.grad.numpy()
                         for k, p in model.named_parameters()})
    return dict(cfg=cfg, variables=variables, jax=jax_out, ranks=ranks,
                single=single, info=info)


def _grads(npz):
    return {k[5:]: v for k, v in npz.items() if k.startswith("grad/")}


def _assert_grads_close(got, want, min_checked=40):
    """Every trainable leaf within max|diff| <= 1e-3 * max|want| + 1e-6;
    the frozen backbone takes no gradient."""
    checked = 0
    for name, w in want.items():
        if name.startswith("backbone."):
            assert name not in got, name
            continue
        g = got.get(name)
        w = np.zeros_like(g) if w is None else np.asarray(w)
        err = np.abs(g - w).max()
        assert err <= 1e-3 * np.abs(w).max() + 1e-6, (name, err)
        checked += 1
    assert checked >= min_checked, checked


CASES = ("people", "rank1_empty")


def test_launch_reports_the_world(run):
    assert run["info"] == {"world": RANKS, "backend": "gloo"}


@pytest.mark.parametrize("case", CASES)
def test_losses_match_jax_mesh(run, case):
    want = run["jax"][case][0]
    for r in range(RANKS):
        got = run["ranks"][case][r]
        for key in LOSS_KEYS:
            np.testing.assert_allclose(float(got[f"metric/{key}"]),
                                       want[key], rtol=1e-4, atol=1e-6,
                                       err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("case", CASES)
def test_grads_match_jax_mesh(run, case):
    want = port_grads(run["cfg"], run["variables"], run["jax"][case][1])
    _assert_grads_close(_grads(run["ranks"][case][0]),
                        {k: v.numpy() for k, v in want.items()})


@pytest.mark.parametrize("case", CASES)
def test_ranks_agree_bit_for_bit(run, case):
    a, b = run["ranks"][case]
    assert set(a) == set(b)
    for key in a:
        if key.startswith(("grad/", "param/")):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_match_one_process(run, case):
    want_metrics, want_grads = run["single"][case]
    got = run["ranks"][case][0]
    for key in LOSS_KEYS:
        np.testing.assert_allclose(float(got[f"metric/{key}"]),
                                   want_metrics[key], rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    _assert_grads_close(_grads(got), want_grads)


def test_empty_rank_count_is_the_ranks_mean(run):
    """With rank 1 empty, a per-rank sample count would leave rank 0's
    gradient twice JAX's: the global one is what the ranks hold."""
    want = port_grads(run["cfg"], run["variables"],
                      run["jax"]["rank1_empty"][1])
    got = _grads(run["ranks"]["rank1_empty"][0])
    name = "decoder.layers.0.class_embed.weight"
    w = want[name].numpy()
    assert np.abs(w).max() > 0
    np.testing.assert_allclose(got[name], w, rtol=1e-3,
                               atol=1e-3 * np.abs(w).max())


def _jax_placement(cfg):
    jb = jax_make_batch(cfg, batch_size=GLOBAL_BATCH, seed=3, num_people=2)
    mesh = make_mesh(RANKS)
    return jb, mesh, jax_shard_batch(jb, mesh)


@pytest.mark.parametrize("rank", range(RANKS))
def test_shard_batch_rows_match_jax_placement(rank):
    cfg = toy_cfg()
    jb, mesh, placed = _jax_placement(cfg)
    device = mesh.devices.reshape(-1)[rank]
    dp = DataParallel(rank=rank, world=RANKS)
    mine = shard_batch(batch_from_jax(jb), dp)
    for name, leaf in (("views", placed.views),
                       ("joints_3d", placed.targets.joints_3d),
                       ("affine", placed.view_data.affine),
                       ("R", placed.view_data.cameras.R)):
        shard = next(s for s in leaf.addressable_shards
                     if s.device == device)
        assert shard.index[0] == dp.rows(GLOBAL_BATCH), name
    np.testing.assert_array_equal(
        mine.views.numpy(), np.asarray(next(
            s.data for s in placed.views.addressable_shards
            if s.device == device)))
    np.testing.assert_array_equal(
        mine.view_data.cameras.T.numpy(),
        np.asarray(jb.view_data.cameras.T)[dp.rows(GLOBAL_BATCH)])


def test_shard_batch_refuses_an_unplaced_field():
    cfg = toy_cfg()
    batch = batch_from_jax(jax_make_batch(cfg, batch_size=2, seed=3))
    Extra = dataclasses.make_dataclass(
        "Extra", [("frame_ids", torch.Tensor, None)], bases=(Batch,))
    extra = Extra(views=batch.views, view_data=batch.view_data,
                  targets=batch.targets, frame_ids=torch.arange(2))
    with pytest.raises(ValueError, match="unplaced Batch field 'frame_ids'"):
        shard_batch(extra, DataParallel(rank=0, world=2))
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(batch, DataParallel(rank=0, world=3))


@pytest.mark.parametrize("device_type, world, cards, want", [
    ("cuda", 2, 2, "nccl"), ("cuda", 8, 8, "nccl"), ("cuda", 2, 1, "gloo"),
    ("cpu", 2, 0, "gloo")])
def test_backend_rule(device_type, world, cards, want):
    assert choose_backend(device_type, world, cards) == want


def test_data_world_on_the_cpu():
    assert data_world(-1, "cpu") == 1
    assert data_world(2, "cpu") == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            data_world(-1, "cuda")
