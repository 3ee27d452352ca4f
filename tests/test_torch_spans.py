"""The port's spans (`utils/profiling.py::span`, `SPANS`) on the CPU, at
toy widths: with no profiler running a span never reaches the profiler's
range; under `torch.profiler` a DQ eval step with top-K, an MvP eval step,
a VoxelPose eval step, a volumetric Learnable Triangulation eval step and a
DQ training step with remat open the spans of `SPANS`, nested as
the layers are (the step, then the backbone, the init, each decoder layer
and the pred or the match, forward, loss, backward and update; inside a
DQ layer the projection, ProjAttn, the top-K and the DLT), and a traced
training step gives the same losses, bit for bit, as an untraced one."""

import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mvgformer_tpu_torch.config import load_config
from mvgformer_tpu_torch.core.infer import make_eval_step
from mvgformer_tpu_torch.core.train import create_train_state, make_train_step
from mvgformer_tpu_torch.data.synthetic import make_batch
from mvgformer_tpu_torch.models import build_model
from mvgformer_tpu_torch.utils.profiling import LAYER, SPANS, span
from torch_one_thread import one_torch_thread  # noqa: F401

THRESHOLD = 0.1
LAYERS = 2
LAYER_NAME = re.compile(r"^mvg\.layer\d+$")


def _cfg(transformer="dq", **overrides):
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
    if transformer == "mvp":
        cfg.TRANSFORMER = "multi_view_pose_transformer"
    if transformer == "voxelpose":
        cfg.TRANSFORMER = "voxelpose"
        cfg.DECODER.num_instance = cfg.MULTI_PERSON.MAX_PEOPLE_NUM
        cfg.MULTI_PERSON.INITIAL_CUBE_SIZE = [8, 8, 4]
        cfg.PICT_STRUCT.CUBE_SIZE = [8, 8, 8]
    if transformer == "volumetric":
        cfg.TRANSFORMER = "volumetric_triangulation"
        cfg.NETWORK.IMAGE_SIZE = [64, 64]
        cfg.NETWORK.VOLUME_FEATURES = 4
        cfg.DECODER.num_instance = 1
        cfg.MULTI_PERSON.MAX_PEOPLE_NUM = 1
        cfg.PICT_STRUCT.CUBE_SIZE = [32, 32, 32]
    for key, value in overrides.items():
        section, name = key.split("__")
        setattr(getattr(cfg, section), name, value)
    return cfg


def _model(cfg):
    return build_model(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")


def _spans(prof):
    """The mvg. spans of a profile: (name, thread, start, end)."""
    return [(e.name, e.thread, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("mvg.")]


def _inside(spans, outer):
    """The names of the spans inside each span named `outer`, one set per
    call."""
    return [{n for n, t, a, b in spans
             if t == ot and oa <= a and b <= ob and (n, a) != (on, oa)}
            for on, ot, oa, ob in spans if on == outer]


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


@pytest.fixture(scope="module")
def dq_serve():
    cfg = _cfg(DECODER__inference_topk_queries=4,
               DECODER__inference_point_topm=2)
    step = make_eval_step(cfg, _model(cfg), THRESHOLD)
    batch = make_batch(cfg, seed=2, num_people=2, device="cpu")
    return step, batch, _traced(lambda: step(batch))[1]


@pytest.fixture(scope="module")
def mvp_serve():
    cfg = _cfg("mvp")
    step = make_eval_step(cfg, _model(cfg), THRESHOLD)
    batch = make_batch(cfg, seed=2, num_people=2, device="cpu")
    return _traced(lambda: step(batch))[1]


@pytest.fixture(scope="module")
def vp_serve():
    cfg = _cfg("voxelpose")
    step = make_eval_step(cfg, _model(cfg), THRESHOLD)
    batch = make_batch(cfg, seed=2, num_people=2, device="cpu")
    return _traced(lambda: step(batch))[1]


@pytest.fixture(scope="module")
def lt_serve():
    cfg = _cfg("volumetric")
    step = make_eval_step(cfg, _model(cfg), THRESHOLD)
    batch = make_batch(cfg, seed=2, num_people=1, device="cpu")
    return _traced(lambda: step(batch))[1]


def _train_step(cfg, traced):
    model = _model(cfg)
    state, tx = create_train_state(cfg, model)
    step = make_train_step(cfg, model, tx)
    batch = make_batch(cfg, seed=2, num_people=2, device="cpu")
    gen = torch.Generator().manual_seed(5)
    run = lambda: step(state, batch, gen)  # noqa: E731
    (_, metrics), spans = _traced(run) if traced else (run(), [])
    return metrics, spans


@pytest.fixture(scope="module")
def dq_train():
    cfg = _cfg(PARALLEL__REMAT_DECODER=True)
    return cfg, _train_step(cfg, traced=True)


def test_span_off_never_reaches_the_profiler(dq_serve, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range opened with no profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    step, batch, _ = dq_serve
    with span("mvg.step"):
        pred = step(batch)
    assert pred.shape[:2] == (1, 16)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="no profiler"):
            span("mvg.step")


def test_dq_eval_step_spans_nest_as_the_layers(dq_serve):
    spans = dq_serve[2]
    layers = {LAYER.format(lid) for lid in range(LAYERS)}
    (step,) = _inside(spans, "mvg.step")
    assert {"mvg.backbone", "mvg.init", "mvg.pred"} | layers <= step
    for name in layers:
        (inner,) = _inside(spans, name)
        assert {"mvg.project", "mvg.projattn", "mvg.dlt"} <= inner
    # top-K selects in layer 0 alone: its stages 6-9, then the compaction
    # the later layers run on
    assert "mvg.topk" in _inside(spans, LAYER.format(0))[0]
    assert "mvg.topk" not in _inside(spans, LAYER.format(1))[0]
    assert sum(n == "mvg.projattn" for n, *_ in spans) == LAYERS
    # point-top-m, once inside each layer's ProjAttn
    assert _inside(spans, "mvg.projattn") == [{"mvg.point_topm"}] * LAYERS


def test_mvp_eval_step_has_no_dlt(mvp_serve):
    spans = mvp_serve
    (step,) = _inside(spans, "mvg.step")
    for lid in range(LAYERS):
        assert LAYER.format(lid) in step
        assert "mvg.projattn" in _inside(spans, LAYER.format(lid))[0]
    assert not {"mvg.dlt", "mvg.topk", "mvg.project"} & {
        n for n, *_ in spans}


def test_train_step_spans_in_order_and_losses_unchanged(dq_train):
    cfg, (metrics, spans) = dq_train
    (step,) = _inside(spans, "mvg.step")
    order = ["mvg.match", "mvg.forward", "mvg.loss", "mvg.backward",
             "mvg.update"]
    assert set(order) <= step
    starts = {n: a for n, _, a, _ in spans if n in order}
    assert sorted(order, key=starts.get) == order
    (forward,) = _inside(spans, "mvg.forward")
    assert {LAYER.format(lid) for lid in range(LAYERS)} <= forward
    # remat: each layer runs again, with its DLT, inside the backward
    assert sum(n == "mvg.dlt" for n, *_ in spans) == 2 * LAYERS
    plain, _ = _train_step(cfg, traced=False)
    assert set(plain) == set(metrics)
    for key in metrics:
        assert torch.equal(metrics[key], plain[key]), key


def test_every_span_is_named_in_spans(dq_serve, mvp_serve, vp_serve,
                                     lt_serve, dq_train):
    opened = {n for n, *_ in dq_serve[2] + mvp_serve + vp_serve + lt_serve
              + dq_train[1][1]}
    named = {LAYER if LAYER_NAME.match(n) else n for n in opened}
    assert named == set(SPANS)
    assert len(SPANS) == len(set(SPANS))
    assert all(n.startswith("mvg.") for n in SPANS)
    # no span's name starts with another's: the benchmark's readers match
    # a span by the prefix of its name
    for a in SPANS:
        assert not any(b != a and b.startswith(a) for b in SPANS), a
