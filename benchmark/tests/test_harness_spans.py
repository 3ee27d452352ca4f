"""The program's spans and counters in a traced window's record
(`benchmark/spans.py`, `benchmark/trace.py`) and the readers of the span
and counter metrics, on synthetic profiler events."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from harness_toy import CHECKOUT  # noqa: F401

from torch.autograd import DeviceType  # noqa: E402

from benchmark import program, run, spans, trace  # noqa: E402

MAIN, AUTOGRAD = 1, 2


def host(name, start, end, thread=MAIN, cid=0):
    return SimpleNamespace(name=name, device_type=DeviceType.CPU,
                           time_range=SimpleNamespace(start=start, end=end),
                           thread=thread, id=cid)


def device(name, start, end, cid):
    return SimpleNamespace(name=name, device_type=DeviceType.CUDA,
                           time_range=SimpleNamespace(start=start, end=end),
                           thread=0, id=cid)


def launch(cid, at, op_start, op_end, thread=MAIN):
    """A kernel and the runtime call that launched it."""
    return [host("cudaLaunchKernel", at, at + 1, thread, cid),
            device("kernel", op_start, op_end, cid)]


# microseconds. The main thread: a step [0, 100) holding a layer [10, 60),
# which holds the DLT [20, 40); the autograd thread holds no span. Kernels:
# 1 launched in the step alone, 2 in the layer, 3 in the DLT, 4 on the
# autograd thread inside the DLT's time, 5 after the step, 6 with no
# runtime call in the window. Device busy [5, 15), [25, 30), [45, 50),
# [70, 80), [105, 110), [112, 113); the window is [0, 120).
EVENTS = (
    [host("mvg.step", 0, 100), host("mvg.layer0", 10, 60),
     host("mvg.dlt", 20, 40), host("aten::mul", 21, 23),
     host("harness", 100, 120)]
    + launch(1, 2, 5, 15)
    + launch(2, 12, 45, 50)
    + launch(3, 22, 25, 30)
    + launch(4, 35, 70, 80, thread=AUTOGRAD)
    + launch(5, 101, 105, 110)
    + [device("kernel", 112, 113, 6),
       # a range's device-side span covers a gap: not an operation
       device("mvg.layer0", 12, 60, 0),
       device("bench.backbone", 5, 80, 0)])


@pytest.fixture(scope="module")
def got():
    return spans.reduce(EVENTS, ("bench.backbone",))


def test_ops_are_charged_to_the_innermost_span(got):
    s = got["spans"]
    assert s["mvg.step"]["ops"] == 1
    assert s["mvg.layer0"]["ops"] == 1
    # the DLT's own and the autograd thread's, which holds no span: the
    # main thread's innermost span at the launch
    assert s["mvg.dlt"]["ops"] == 2
    assert s["mvg.dlt"]["device_s"] == pytest.approx(15e-6)


def test_spans_ops_and_the_unspanned_are_the_device_ops(got):
    assert got["device_ops"] == 6  # the device-side ranges left out
    assert got["unspanned"]["ops"] == 2
    assert got["unspanned"]["unlinked"] == 1
    assert sum(v["ops"] for v in got["spans"].values()) \
        + got["unspanned"]["ops"] == got["device_ops"]


def test_host_and_self_time(got):
    s = got["spans"]
    assert s["mvg.step"]["calls"] == 1
    assert s["mvg.step"]["host_s"] == pytest.approx(100e-6)
    assert s["mvg.step"]["self_s"] == pytest.approx(50e-6)
    assert s["mvg.layer0"]["self_s"] == pytest.approx(30e-6)
    assert s["mvg.dlt"]["self_s"] == s["mvg.dlt"]["host_s"] \
        == pytest.approx(20e-6)


def test_idle_gaps_go_to_the_main_threads_innermost_span(got):
    s = got["spans"]
    # the gaps [0, 5), [15, 25), [30, 45), [50, 70), [80, 105), [110, 112)
    # and [113, 120), each by where it starts; the ranges' device-side
    # spans fill none of them
    assert s["mvg.step"]["idle_s"] == pytest.approx((5 + 25) * 1e-6)
    assert s["mvg.layer0"]["idle_s"] == pytest.approx((10 + 20) * 1e-6)
    assert s["mvg.dlt"]["idle_s"] == pytest.approx(15e-6)
    assert got["unspanned"]["idle_s"] == pytest.approx((2 + 7) * 1e-6)
    assert got["idle_s"] == pytest.approx((120 - 36) * 1e-6)
    assert got["idle_s"] == pytest.approx(
        sum(v["idle_s"] for v in s.values()) + got["unspanned"]["idle_s"])
    assert dict(got["idle_by_span"]) == pytest.approx(
        {"mvg.step": 30e-6, "mvg.layer0": 30e-6, "mvg.dlt": 15e-6})


def test_the_autograd_threads_recompute_takes_its_own_ops_and_gaps():
    """The main thread waits in its backward [0, 100) while the autograd
    thread recomputes a layer's DLT [20, 50) and launches the backward's
    kernels outside any span."""
    events = ([host("mvg.backward", 0, 100),
               host("mvg.dlt", 20, 50, AUTOGRAD)]
              + launch(1, 30, 40, 45, AUTOGRAD)
              + launch(2, 60, 70, 75, AUTOGRAD))
    s = spans.reduce(events)["spans"]
    assert s["mvg.dlt"]["ops"] == s["mvg.backward"]["ops"] == 1
    # [0, 40) and [75, 100) in the backward, [45, 70) in the recompute
    assert s["mvg.backward"]["idle_s"] == pytest.approx(65e-6)
    assert s["mvg.dlt"]["idle_s"] == pytest.approx(25e-6)
    # each thread's spans nest on their own: the backward holds none
    assert s["mvg.backward"]["self_s"] == pytest.approx(100e-6)


def test_no_spans_no_charge():
    bare = [e for e in EVENTS if not e.name.startswith("mvg.")]
    got = spans.reduce(bare, ("bench.backbone",))
    assert got["spans"] == {} and got["idle_by_span"] == []
    assert got["unspanned"]["ops"] == got["device_ops"] == 6


RECORD = {"frames": 2, "frame_s": 0.05, "window_s": 0.2,
          "spans": {"mvg.dlt": {"ops": 800, "host_s": 0.08},
                    "mvg.projattn": {"ops": 40, "host_s": 0.02},
                    "mvg.layer0": {"ops": 10, "host_s": 0.06},
                    "mvg.layer1": {"ops": 10, "host_s": 0.04}}}
TRAIN = {"steps": 2, "step_s": 1.0, "window_s": 4.0,
         "spans": {"mvg.dlt": {"ops": 30000, "host_s": 1.0},
                   "mvg.forward": {"ops": 100, "host_s": 0.8},
                   "mvg.backward": {"ops": 100, "host_s": 2.0}}}


@pytest.mark.parametrize("name,record,value", [
    ("dlt_ops_per_frame.serve", RECORD, 400.0),
    ("dlt_host_ms.serve", RECORD, 20.0),
    ("projattn_host_ms.serve", RECORD, 5.0),
    ("decoder_host_ms.serve", RECORD, 25.0),
    ("dlt_ops_per_step.train", TRAIN, 15000.0),
    ("forward_host_ms.train", TRAIN, 200.0),
    ("backward_host_ms.train", TRAIN, 500.0)])
def test_span_readers(name, record, value):
    reader = run.module_at(run.HERE / "metrics" / f"{name}.py")
    assert reader.read(record) == pytest.approx(value)
    # no spans in the record (a program without them): nothing
    assert reader.read({k: v for k, v in record.items()
                        if k != "spans"}) is None


@pytest.mark.parametrize("name", spans.SPAN_METRICS)
def test_span_readers_leave_out_what_did_not_run(name):
    reader = run.module_at(run.HERE / "metrics" / f"{name}.py")
    # MvP has no DLT; a serving record is no training step and the reverse
    mvp = dict(RECORD, spans={k: v for k, v in RECORD["spans"].items()
                              if k != "mvg.dlt"})
    if "dlt" in name or name.endswith(".train"):
        assert reader.read(mvp) is None
    if name.endswith(".serve"):
        assert reader.read(TRAIN) is None


# EVENTS less the device-side span of `mvg.layer0`, which the trace counts
# as an operation and the spans do not
TRACED = [e for e in EVENTS
          if not (e.device_type == DeviceType.CUDA and e.name == "mvg.layer0")]


def test_the_record_holds_the_spans_beside_its_keys():
    got = trace.record(TRACED, 0.5, ("bench.backbone",))
    # the keys the record held before it held the spans, as they were
    assert got["window_s"] == 0.5
    assert got["busy_s"] == pytest.approx(36e-6)
    assert got["device_ops"] == 6
    assert got["kernels"] == {"kernel": [pytest.approx(36e-6), 6]}
    assert got["ranges"] == {"bench.backbone": 0.0}
    assert got["breakdown"]["device_ops"] == [["kernel",
                                               pytest.approx(36e-6)]]
    assert got["breakdown"]["idle_gaps"] == [
        ["mvg.step", pytest.approx(25e-6)],
        ["mvg.layer0", pytest.approx(20e-6)],
        ["mvg.dlt", pytest.approx(15e-6)],
        ["mvg.layer0", pytest.approx(10e-6)],
        ["harness", pytest.approx(2e-6)]]
    # the spans, as `spans.reduce` gives them for the same events
    want = spans.reduce(TRACED, ("bench.backbone",))
    assert got["spans"] == want["spans"]
    assert got["unspanned"] == want["unspanned"]
    assert got["breakdown"]["idle_by_span"] == want["idle_by_span"]
    assert sum(v["ops"] for v in got["spans"].values()) \
        + got["unspanned"]["ops"] == got["device_ops"]
    assert got["counters"] == {}


def test_an_ops_mismatch_leaves_the_spans_out(capsys):
    got = trace.record(EVENTS, 0.5, ("bench.backbone",))
    assert got["device_ops"] == 7  # the span's device side counted
    assert "spans" not in got and "unspanned" not in got
    assert "idle_by_span" not in got["breakdown"]
    assert "spans left out" in capsys.readouterr().err
    # so the span readers read nothing, and the rest reads as before
    record = dict(got, frames=1, frame_s=0.05)
    for name in spans.SPAN_METRICS:
        reader = run.module_at(run.HERE / "metrics" / f"{name}.py")
        assert reader.read(record) is None
    # [12, 60) joins [5, 15) and [45, 50): 55 + 10 + 5 + 1 us busy
    assert got["busy_s"] == pytest.approx(71e-6)


def test_the_span_readers_read_the_record():
    record = dict(trace.record(TRACED, 0.5, ("bench.backbone",)),
                  frames=2, frame_s=0.25)
    read = {name: run.module_at(run.HERE / "metrics" / f"{name}.py").read(
        record) for name in spans.SPAN_METRICS}
    assert read["dlt_ops_per_frame.serve"] == 1.0  # 2 ops, 2 frames
    # 20 us of the traced 0.5 s, at 0.25 untraced s a frame
    assert read["dlt_host_ms.serve"] == pytest.approx(1e3 * 20e-6 / 0.5
                                                      * 0.25)
    assert read["decoder_host_ms.serve"] == pytest.approx(1e3 * 50e-6
                                                          / 0.5 * 0.25)
    assert read["projattn_host_ms.serve"] is None  # no such span ran
    assert all(read[n] is None for n in spans.SPAN_METRICS
               if n.endswith(".train"))


def test_traced_records_the_counters_its_units_moved(monkeypatch):
    """The port's counters, its registry where it has one, moved inside
    the traced function, and only there."""
    import collections

    import torch

    from mvgformer_tpu_torch.ops.dlt_jacobi import fused_dlt
    from mvgformer_tpu_torch.parallel import collectives
    from mvgformer_tpu_torch.utils import profiling

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(profiling, program.REGISTRY, collections.Counter(
        {"model.calls": 4}), raising=False)
    monkeypatch.setattr(fused_dlt, "launches", fused_dlt.launches + 3)
    monkeypatch.setattr(collectives, "COUNTS", collections.Counter())
    real = trace.record
    # the CPU's profiler sees no device: the events of EVENTS stand in
    monkeypatch.setattr(trace, "record", lambda events, *rest: real(
        list(events) + TRACED, *rest))

    def unit():
        fused_dlt.launches += 4
        fused_dlt.plain_calls += 1
        collectives.COUNTS["view.all_gather"] += 2
        getattr(profiling, program.REGISTRY)["model.calls"] += 1

    got = trace.traced(unit, 2, ("bench.backbone",))
    assert got["counters"] == {"fused_dlt.launches": 8,
                               "fused_dlt.plain_calls": 2,
                               "collectives.view.all_gather": 4,
                               "model.calls": 2}
    assert got["device_ops"] == 6 and "spans" in got


@pytest.mark.parametrize("counters,value", [
    ({"fused_dlt.launches": 8, "fused_dlt.plain_calls": 0}, 100.0),
    ({"fused_dlt.launches": 0, "fused_dlt.plain_calls": 8}, 0.0),
    ({"fused_dlt.launches": 3, "fused_dlt.plain_calls": 1}, 75.0),
    ({"fused_dlt.launches": 0, "fused_dlt.plain_calls": 0}, None),
    ({}, None)])
def test_dlt_fused_pct(counters, value):
    reader = run.module_at(run.HERE / "metrics" / "dlt_fused_pct.serve.py")
    assert reader.read({"counters": counters}) == value
    assert reader.read({}) is None  # a record without counters


def test_counters_say_when_the_port_has_no_registry(monkeypatch, capsys):
    """Without the port's registry the snapshot holds the counters it reads
    by name and says on standard error which registry it missed; with it,
    every count of the registry and no such line."""
    import collections

    from mvgformer_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, program.REGISTRY, raising=False)
    got = program.counters()
    assert {"fused_dlt.launches", "fused_dlt.plain_calls"} <= set(got)
    assert f"no registry utils/profiling.py::{program.REGISTRY}" \
        in capsys.readouterr().err
    monkeypatch.setattr(profiling, program.REGISTRY, collections.Counter(
        {"model.calls": 2}), raising=False)
    assert program.counters()["model.calls"] == 2
    assert capsys.readouterr().err == ""
