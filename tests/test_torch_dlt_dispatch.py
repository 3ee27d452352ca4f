"""The dispatch of a DQ decoder layer's DLT (`ops/dlt_jacobi.py`) on the
CPU, at toy widths:

  * the rule `fused_path`: the kernel on CUDA for the 'jacobi' solver when
    the views are not split, in every grad mode; a split grid, 'eigh',
    'svd', 'st' and the CPU take the plain chain, and only CUDA Jacobi
    calls count in `fused_dlt.plain_calls`;
  * `fused_dlt` on CPU tensors is `plain_dlt`, launches nothing, and checks
    shapes and devices first;
  * a served toy model on the CPU, each solver, takes the plain chain and
    counts nothing; with the rule told the points are on the card, the
    fused branch (on the CPU, `plain_dlt`) gives the plain chain's bits,
    with and without bayesian_update and top-K, and so does a training
    step, its clip passed on, with and without remat; the plain chain is
    `image_points` then `solve_views` for each DLT solver;
  * a served top-K frame selects its queries once, in layer 1, and gives
    the dense frame's pred at them.
"""

import pytest
import torch

from mvgformer_tpu_torch.config import load_config
from mvgformer_tpu_torch.core.infer import make_eval_step
from mvgformer_tpu_torch.core.train import create_train_state, make_train_step
from mvgformer_tpu_torch.data.synthetic import make_batch
from mvgformer_tpu_torch.geometry.cameras import CameraParams
from mvgformer_tpu_torch.models import build_model, decoder
from mvgformer_tpu_torch.ops import dlt_jacobi
from mvgformer_tpu_torch.ops.dlt_jacobi import fused_dlt, fused_path, plain_dlt
from torch_one_thread import one_torch_thread  # noqa: F401

THRESHOLD = 0.1
LAYERS = 2
CUDA = torch.device("cuda")  # the rule reads the device; no card needed


def _cfg(**overrides):
    cfg = load_config()
    cfg.NETWORK.IMAGE_SIZE = [96, 64]
    cfg.DECODER.d_model = 32
    cfg.DECODER.dim_feedforward = 64
    cfg.DECODER.nhead = 4
    cfg.DECODER.dec_n_points = 4
    cfg.DECODER.num_decoder_layers = LAYERS
    cfg.DECODER.num_instance = 16
    cfg.DECODER.triangulation_method = "jacobi"
    cfg.POSE_RESNET.NUM_LAYERS = 18
    cfg.POSE_RESNET.NUM_DECONV_FILTERS = [32, 32, 32]
    cfg.DATASET.CAMERA_NUM = 3
    cfg.MULTI_PERSON.MAX_PEOPLE_NUM = 4
    cfg.PARALLEL.COMPUTE_DTYPE = "float32"
    for key, value in overrides.items():
        section, name = key.split("__")
        setattr(getattr(cfg, section), name, value)
    return cfg


def _model(cfg):
    return build_model(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")


@pytest.fixture
def counters():
    """fused_dlt's counts so far; the test reads what it added."""
    start = (fused_dlt.launches, fused_dlt.plain_calls)
    return lambda: (fused_dlt.launches - start[0],
                    fused_dlt.plain_calls - start[1])


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("solver", ["jacobi", "eigh", "svd", "st"])
@pytest.mark.parametrize("device", [CUDA, torch.device("cpu")],
                         ids=["cuda", "cpu"])
def test_fused_path_rule(counters, device, solver, split):
    """The rule reads the device, the solver and the split alone: the
    kernels on CUDA with 'jacobi' and every view on this process, in
    serving and training alike; a CUDA Jacobi call under a view split
    counts as plain, and nothing else counts."""
    cuda_jacobi = device.type == "cuda" and solver == "jacobi"
    assert fused_path(device, solver, split) is (cuda_jacobi and not split)
    assert counters() == (0, int(cuda_jacobi and split))


def _operands(B=2, N=6, V=3, seed=0):
    gen = torch.Generator().manual_seed(seed)
    eye = torch.eye(3).expand(B, V, 3, 3)
    cams = CameraParams(R=eye.contiguous(),
                        T=torch.randn(B, V, 3, 1, generator=gen) * 100,
                        f=torch.full((B, V, 2), 500.0),
                        c=torch.full((B, V, 2), 300.0),
                        k=torch.randn(B, V, 3, generator=gen) * 0.01,
                        p=torch.randn(B, V, 2, generator=gen) * 1e-3)
    inv_affine = torch.tensor([[2.0, 0.0, 1.0], [0.0, 2.0, -1.0]]).expand(
        B, V, 2, 3).contiguous()
    proj = torch.randn(B, V, 3, 4, generator=gen)
    return dict(refined=torch.rand(V, B, N, 2, generator=gen) * 100,
                logits=torch.randn(V, B, N, generator=gen),
                mask=torch.rand(B, N, generator=gen) > 0.3,
                inv_affine=inv_affine, cameras=cams, proj=proj)


def test_fused_dlt_on_the_cpu_is_the_plain_chain(counters):
    ops = _operands()
    got = fused_dlt(**ops)
    assert torch.equal(got, plain_dlt(**ops))
    assert got.shape == (2, 6, 3)
    assert torch.equal(got[~ops["mask"]], torch.zeros_like(
        got[~ops["mask"]]))
    assert counters() == (0, 0)


@pytest.mark.parametrize("field,value,match", [
    ("logits", torch.zeros(3, 2, 5), "logits must be"),
    ("mask", torch.ones(2, 5, dtype=torch.bool), "mask must be"),
    ("proj", torch.zeros(2, 3, 4, 4), "proj must be"),
    ("inv_affine", torch.zeros(2, 2, 2, 3), "inv_affine must be"),
    ("refined", torch.zeros(3, 2, 6, 3), r"refined must be \(V, B, N, 2\)"),
    ("mask", torch.ones(2, 6, dtype=torch.bool, device="meta"),
     "several devices"),
])
def test_fused_dlt_checks_shapes_and_devices(field, value, match):
    ops = _operands()
    ops[field] = value
    with pytest.raises(ValueError, match=match):
        fused_dlt(**ops)


def test_fused_dlt_refuses_other_devices():
    ops = {k: (v.to("meta") if torch.is_tensor(v) else v)
           for k, v in _operands().items()}
    ops["cameras"] = CameraParams(**{
        name: getattr(ops["cameras"], name).to("meta")
        for name in ("R", "T", "f", "c", "k", "p")})
    with pytest.raises(ValueError, match="unsupported device"):
        fused_dlt(**ops)


def _serve(cfg, batch):
    return make_eval_step(cfg, _model(cfg), THRESHOLD)(batch)


def _spy(monkeypatch, name):
    """Record the arguments of every call of dlt_jacobi's `name`."""
    calls, original = [], getattr(dlt_jacobi, name)

    def spy(*args, **kwargs):
        calls.append(args)
        return original(*args, **kwargs)

    monkeypatch.setattr(dlt_jacobi, name, spy)
    return calls


@pytest.mark.parametrize("solver", ["jacobi", "eigh", "svd", "st"])
def test_served_layers_on_the_cpu_take_the_plain_chain(monkeypatch, counters,
                                                       solver):
    cfg = _cfg(DECODER__triangulation_method=solver)
    batch = make_batch(cfg, seed=2, num_people=2, device="cpu")
    step8 = _spy(monkeypatch, "image_points")
    step9 = _spy(monkeypatch, "solve_views")
    pred = _serve(cfg, batch)
    assert torch.isfinite(pred).all()
    assert counters() == (0, 0)
    # every layer's step 8, and a DLT solver's step 9, on the one chain;
    # 'st' solves in the layer
    assert len(step8) == LAYERS
    assert [args[4] for args in step9] == (
        [] if solver == "st" else [solver] * LAYERS)


def _as_if_on_the_card(monkeypatch):
    """The rule as it decides for CUDA tensors; the fused branch then runs
    fused_dlt on the CPU, which is plain_dlt."""
    rule = dlt_jacobi.fused_path
    monkeypatch.setattr(
        dlt_jacobi, "fused_path",
        lambda device, *args: rule(CUDA, *args))


@pytest.mark.parametrize("overrides", [
    {}, {"DECODER__bayesian_update": True},
    {"DECODER__inference_topk_queries": 8},
    {"DECODER__inference_topk_queries": 8, "DECODER__bayesian_update": True},
], ids=["dense", "bayesian", "topk", "topk_bayesian"])
def test_fused_branch_gives_the_plain_chains_bits(monkeypatch, counters,
                                                   overrides):
    cfg = _cfg(**overrides)
    batch = make_batch(cfg, seed=4, num_people=3, device="cpu")
    model = _model(cfg)
    step = make_eval_step(cfg, model, THRESHOLD)
    want = step(batch)
    with torch.inference_mode():
        want_outs = model(batch, threshold=THRESHOLD)
    assert counters() == (0, 0)
    _as_if_on_the_card(monkeypatch)
    calls = []

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return plain_dlt(*args, **kwargs)

    monkeypatch.setattr(dlt_jacobi, "plain_dlt", spy)
    got = step(batch)
    with torch.inference_mode():
        got_outs = model(batch, threshold=THRESHOLD)
    assert len(calls) == 2 * LAYERS  # every layer took the fused branch
    assert torch.equal(got, want)
    for a, b in zip(got_outs, want_outs):
        for key in ("pred_poses", "pred_logits", "pred_poses_2d"):
            assert torch.equal(a[key], b[key]), key
    # nothing launched on the CPU, and no Jacobi call went plain
    assert counters() == (0, 0)


def test_served_topk_selects_once_a_frame(monkeypatch):
    """Layer 1's top-K is selected once a frame, in the layer; the later
    layers and the outputs use that selection. At the kept queries the
    pred is the dense frame's (no top-K), bit for bit; the dropped ones
    read as zeros, flagged."""
    cfg = _cfg(DECODER__inference_topk_queries=8)
    batch = make_batch(cfg, seed=4, num_people=3, device="cpu")
    model = _model(cfg)
    taken, original = [], decoder.top_indices

    def spy(scores, k):
        taken.append(original(scores, k))
        return taken[-1]

    monkeypatch.setattr(decoder, "top_indices", spy)
    step = make_eval_step(cfg, model, THRESHOLD)
    pred = step(batch)
    assert len(taken) == 1
    assert torch.equal(step(batch), pred)
    assert len(taken) == 2
    cfg.DECODER.inference_topk_queries = None
    dense = make_eval_step(cfg, model, THRESHOLD)(batch)
    assert len(taken) == 2
    rows = torch.arange(pred.shape[0])[:, None]
    sel = taken[0]
    assert sel.shape == (pred.shape[0], 8)
    assert torch.equal(pred[rows, sel], dense[rows, sel])
    dropped = torch.ones(pred.shape[:2], dtype=torch.bool)
    dropped[rows, sel] = False
    assert torch.equal(pred[dropped][..., :3],
                       torch.zeros_like(pred[dropped][..., :3]))
    assert (pred[dropped][..., 3] == -1.0).all()


@pytest.mark.parametrize("remat", [False, True])
def test_training_keeps_the_plain_chain(monkeypatch, counters, remat):
    """Training keeps the plain chain's bits through the fused branch. A
    training step on the CPU runs the plain chain; with the rule told the
    points are on the card, every layer takes the fused branch (on the
    CPU, `plain_dlt`, with the layer's TRI_GRAD_CLIP), again in the remat
    recompute, and the losses and the updated parameters are the plain
    chain's bits. Nothing launches, and no call counts as plain."""
    cfg = _cfg(PARALLEL__REMAT_DECODER=remat, TRAIN__TRI_GRAD_CLIP=1.0)
    batch = make_batch(cfg, seed=6, num_people=2, device="cpu")

    def step_once():
        model = _model(cfg)
        state, tx = create_train_state(cfg, model)
        step = make_train_step(cfg, model, tx)
        _, metrics = step(state, batch, torch.Generator().manual_seed(5))
        return metrics, {k: v.detach().clone()
                         for k, v in model.named_parameters()}

    want, want_params = step_once()
    _as_if_on_the_card(monkeypatch)
    clips = []

    def spy(*args, **kwargs):
        clips.append(args[6])
        return plain_dlt(*args, **kwargs)

    monkeypatch.setattr(dlt_jacobi, "plain_dlt", spy)
    got, got_params = step_once()
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(torch.as_tensor(got[key]),
                           torch.as_tensor(want[key])), key
    for key in want_params:
        assert torch.equal(got_params[key], want_params[key]), key
    # each layer's forward, and again in the remat recompute
    assert clips == [1.0] * LAYERS * (2 if remat else 1)
    assert counters() == (0, 0)
