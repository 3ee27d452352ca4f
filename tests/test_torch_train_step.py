"""The port's training step (core/train.py) against JAX's make_train_step on
a toy config (tools/make_golden.py's toy widths with the ResNet-18 trunk of
tests/test_model.py::small_cfg), Jacobi DLT, decoder remat, dropout 0 (the
two frameworks' dropout generators cannot agree), the same weights carried
across by port_state_dict_from_jax and the same synthetic batch:

  * step 1: every loss term at rtol 1e-4 (float32 sums of ~1e4-sized terms
    in another order through four layers of geometry);
  * step 1: every trainable gradient leaf within max|diff| <= 1e-3 *
    max|g_jax| + 1e-6, JAX's gradients carried through the same converter
    (linear on every non-backbone leaf); the frozen backbone takes none;
  * after 3 steps: every loss term at rtol 1e-4, the parameters in the same
    class, and the backbone bitwise unchanged. Adam divides each element by
    its own gradient's size, so an element whose step-1 gradient is below
    the gradient class's resolution (float32 noise of a sum whose largest
    terms are ~1e6 times larger) moves by +-lr on the sign of that noise;
    such elements are held only to the most three Adam steps can move one
    (|m_hat / sqrt(v_hat)| <= 1.005 for t <= 3 at b1 0.9, b2 0.999).

Jacobi's unrolled 6-sweep solve makes XLA's CPU compile of the JAX step
take minutes (its gradient alone ~5 min), so on the JAX side
`jacobi4_smallest` is evaluated op by op on the host: a custom VJP whose
forward and backward are pure callbacks into JAX's own function and
jax.vjp of it. The arithmetic is JAX's; only its fusion into the compiled
step is skipped. The rest of the step compiles as JAX runs it.

Also here, sharing those host-side Jacobi evaluations: autograd through
the port's jacobi4_smallest stays finite on near-degenerate Gram matrices
(JAX's relative skip guard) and equals JAX's VJP there.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import make_golden  # noqa: E402

from mvgformer_tpu.core import criterion as jcrit  # noqa: E402
from mvgformer_tpu.core import train as jtrain  # noqa: E402
from mvgformer_tpu.data.synthetic import make_batch as jax_make_batch  # noqa: E402
from mvgformer_tpu.geometry import triangulate as jtri  # noqa: E402
from mvgformer_tpu.models.mvgformer import MVGFormer as JMVGFormer  # noqa: E402
from mvgformer_tpu_torch.core import train  # noqa: E402
from mvgformer_tpu_torch.data.synthetic import batch_from_jax  # noqa: E402
from mvgformer_tpu_torch.geometry.triangulate import jacobi4_smallest  # noqa: E402
from mvgformer_tpu_torch.models.mvgformer import MVGFormer  # noqa: E402
from mvgformer_tpu_torch.utils.jax_convert import port_state_dict_from_jax  # noqa: E402

STEPS = 3
_JACOBI = jtri.jacobi4_smallest


def _jacobi_host(G):
    return np.asarray(_JACOBI(jnp.asarray(G)))


def _jacobi_vjp_host(G, ct):
    _, vjp = jax.vjp(_JACOBI, jnp.asarray(G))
    return np.asarray(vjp(jnp.asarray(ct))[0])


@jax.custom_vjp
def _jacobi_hosted(G):
    return jax.pure_callback(
        _jacobi_host, jax.ShapeDtypeStruct(G.shape[:-1], jnp.float32), G)


def _jacobi_hosted_fwd(G):
    return _jacobi_hosted(G), G


def _jacobi_hosted_bwd(G, ct):
    return (jax.pure_callback(
        _jacobi_vjp_host, jax.ShapeDtypeStruct(G.shape, G.dtype), G, ct),)


_jacobi_hosted.defvjp(_jacobi_hosted_fwd, _jacobi_hosted_bwd)


def toy_train_cfg():
    cfg = make_golden.toy_cfg(topk=None, solver="jacobi")
    cfg.POSE_RESNET.NUM_LAYERS = 18
    cfg.DECODER.dropout = 0.0
    assert cfg.PARALLEL.REMAT_DECODER and cfg.DECODER.gt_match
    return cfg


def _jax_steps(cfg, batch):
    """JAX's initial variables, step-1 losses and gradients, and the
    metrics and parameters of STEPS steps of make_train_step."""
    jm = JMVGFormer(cfg=cfg)
    state, tx = jtrain.create_train_state(cfg, jm, batch,
                                          jax.random.PRNGKey(0))

    def loss_fn(params):
        # make_train_step's loss, whose gradient the step does not return
        init_refs = jm.initial_reference_points_static(1)
        match = jcrit.match_queries(cfg, init_refs, batch)
        outs = jm.apply({"params": params, "batch_stats": state.batch_stats},
                        batch, query_mask=match.query_mask, train=True,
                        rngs={"dropout": jax.random.PRNGKey(1)})
        return jcrit.compute_losses(cfg, outs, batch, match,
                                    init_reference=init_refs)["total"]

    grads = jax.jit(jax.grad(loss_fn))(state.params)
    step = jtrain.make_train_step(cfg, jm, tx, donate=False)
    s, metrics = state, []
    for i in range(STEPS):
        s, m = step(s, batch, jax.random.PRNGKey(i + 1))
        metrics.append(m)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    variables = {"params": to_np(state.params),
                 "batch_stats": to_np(state.batch_stats)}
    return variables, to_np(grads), to_np(metrics), to_np(s.params)


@pytest.fixture(scope="module")
def run():
    cfg = toy_train_cfg()
    jb = jax_make_batch(cfg, batch_size=1, seed=3, num_people=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtri, "jacobi4_smallest",
                   lambda G, sweeps=6: _jacobi_hosted(G))
        variables, jgrads, jmetrics, jparams = _jax_steps(cfg, jb)

    def convert(params):
        return port_state_dict_from_jax(
            {"params": params, "batch_stats": variables["batch_stats"]}, cfg)

    model = MVGFormer(cfg, device="cpu")
    model.load_state_dict(convert(variables["params"]))
    params0 = {k: p.detach().clone() for k, p in model.named_parameters()}
    backbone0 = {k: v.clone() for k, v in model.state_dict().items()
                 if k.startswith("backbone.")}
    state, tx = train.create_train_state(cfg, model)
    step = train.make_train_step(cfg, model, tx)
    batch = batch_from_jax(jb)
    metrics = []
    for i in range(STEPS):
        state, m = step(state, batch)
        metrics.append(m)
        if i == 0:
            grads = {k: p.grad for k, p in model.named_parameters()}
    return {"cfg": cfg, "model": model, "tx": tx, "params0": params0,
            "backbone0": backbone0, "grads": grads, "metrics": metrics,
            "jax_grads": convert(jgrads), "jax_metrics": jmetrics,
            "jax_params": convert(jparams)}


@pytest.mark.parametrize("step", [0, STEPS - 1])
def test_losses_match_jax(run, step):
    got, want = run["metrics"][step], run["jax_metrics"][step]
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-4, atol=1e-6, err_msg=key)


def test_step1_grads_match_jax(run):
    checked = 0
    for name, g in run["grads"].items():
        want = run["jax_grads"][name].numpy()
        if name.startswith("backbone."):
            assert g is None, name
            assert not np.any(want), name
            continue
        assert g is not None, name
        err = np.abs(g.numpy() - want).max()
        assert err <= 1e-3 * np.abs(want).max() + 1e-6, (name, err)
        checked += 1
    assert checked > 50


def test_three_steps_params_match_jax(run):
    labels = run["tx"].labels(run["params0"])
    lr = run["cfg"].TRAIN.LR
    for name, p in run["model"].named_parameters():
        got, want = p.detach().numpy(), run["jax_params"][name].numpy()
        if labels[name] == "frozen":
            np.testing.assert_array_equal(got, run["params0"][name].numpy())
            continue
        diff = np.abs(got - want)
        g1 = run["jax_grads"][name].numpy()
        determined = np.abs(g1) > 1e-3 * np.abs(g1).max() + 1e-6
        tol = 1e-3 * np.abs(want).max() + 1e-6
        assert diff[determined].max(initial=0.0) <= tol, (name, diff.max())
        bound = 2 * STEPS * 1.005 * lr * run["tx"].scale[labels[name]]
        assert diff.max() <= bound + tol, (name, diff.max())


def test_backbone_unchanged(run):
    sd = run["model"].state_dict()
    for k, v in run["backbone0"].items():
        assert torch.equal(sd[k], v), k


def _near_degenerate_grams(seed):
    """Gram matrices with repeated, zero and nearly equal eigenvalues and
    off-diagonals far below the diagonal: where an unguarded Jacobi
    rotation's VJP divides by a vanishing off-diagonal."""
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(6, 4, 4))
    eig = np.array([[1.0, 1.0, 1.0, 1.0], [1.0, 1.0, 1e-7, 0.0],
                    [5.0, 5.0 + 1e-6, 2.0, 1e-9], [1e3, 1.0, 1.0, 1e-6],
                    [1.0, 2.0, 3.0, 4.0], [1.0, 1.0 + 1e-7, 1.0, 0.0]])
    grams = np.einsum("bij,bj,bkj->bik", q, eig, q)
    diag = np.diag(rng.rand(4) + 0.5)
    tiny = diag + 1e-20 * (1.0 - np.eye(4))
    return np.concatenate([grams, diag[None], tiny[None]]).astype(
        np.float32)


def test_jacobi_grad_finite_on_near_degenerate_grams():
    G = _near_degenerate_grams(0)
    ct = np.random.RandomState(1).randn(len(G), 4).astype(np.float32)
    tg = torch.from_numpy(G).requires_grad_(True)
    v = jacobi4_smallest(tg)
    v.backward(torch.from_numpy(ct))
    assert torch.isfinite(v).all() and torch.isfinite(tg.grad).all()
    np.testing.assert_allclose(v.detach().numpy(), _jacobi_host(G),
                               rtol=0, atol=1e-5)
    # the same rotations in the same order: the VJPs agree to float32
    # rounding of entries up to ~1e2
    want = _jacobi_vjp_host(G, ct)
    np.testing.assert_allclose(tg.grad.numpy(), want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()))
