"""The window's statistics on synthetic timestamps, and the per-layer
readers on a synthetic record."""

from __future__ import annotations

import statistics

import numpy as np
import pytest

from harness_toy import CHECKOUT  # noqa: F401

import torch  # noqa: E402

from benchmark import check, run, stats, trace


def test_rate_is_all_the_work_over_all_the_time():
    # 3 units of 8 frames whose results reach the host at 0.5, 1.2 and
    # 2.9 s of a 3 s window: the slow third unit weighs as much as it took
    spans = [(0.0, 0.5, 8), (0.5, 1.2, 8), (1.2, 2.9, 8)]
    assert stats.rate(spans, 3.0) == pytest.approx(24 / 3.0)
    assert stats.rate(spans, 3.0) != pytest.approx(
        statistics.median(8 / (e - s) for s, e, _ in spans))


def test_p95_is_over_every_frame():
    lat = np.arange(1, 201) / 1e3  # 1..200 ms, one frame each
    spans = [(10.0, 10.0 + x, 1) for x in lat]
    assert stats.p95_ms(spans) == pytest.approx(
        np.percentile(np.arange(1, 201), 95))


def test_spread_is_the_quartile_distance_over_the_median():
    v = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / q2)


def test_union_and_gaps_of_device_intervals():
    spans = [(0.0, 10.0), (5.0, 12.0), (20.0, 25.0)]
    assert trace.merged(spans) == [(0.0, 12.0), (20.0, 25.0)]
    out = trace.breakdown({"k": [17e-6, 3]}, spans,
                          [(11.0, 30.0, "host_op"), (12.5, 13.0, "inner")])
    assert out["idle_gaps"] == [["host_op", pytest.approx(8e-6)]]
    assert out["device_ops"] == [["k", 17e-6]]


RECORD = {"frames": 4, "busy_s": 0.1, "frame_s": 0.1, "device_ops": 400,
          "flops_per_frame": 1e12, "peak_flops": 1e15,
          "kernels": {"void deform_sample_fwd_kernel<bf16>": [0.002, 16],
                      "gemm": [0.05, 40]},
          "ranges": {"bench.backbone": 0.02}}


@pytest.mark.parametrize("name,value", [
    ("device_idle.serve", 75.0), ("mfu.serve", 1.0),
    ("device_ops_per_frame.serve", 100.0),
    ("backbone_device_ms.serve", 5.0), ("b1_device_ms.serve", 0.5)])
def test_readers_on_a_record(name, value):
    reader = run.module_at(run.HERE / "metrics" / f"{name}.py")
    assert reader.read(RECORD) == pytest.approx(value)


@pytest.mark.parametrize("name", ["backbone_device_ms.serve",
                                  "b1_device_ms.serve"])
def test_readers_that_find_nothing_return_nothing(name):
    reader = run.module_at(run.HERE / "metrics" / f"{name}.py")
    assert reader.read(dict(RECORD, kernels={}, ranges={})) is None


def test_near_ties_are_the_queries_near_the_threshold_in_any_layer():
    """Layer 1 over every query, the later layers over the selected ones:
    a query within MASK_BAND of the threshold in either is a near tie."""
    t = 0.1
    first = torch.tensor([[[0, t + 0.5 * check.MASK_BAND], [0, 0.5],
                           [0, 0.9], [0, t - 2 * check.MASK_BAND]]])
    later = torch.tensor([[[0, 0.8], [0, t - 0.5 * check.MASK_BAND]]])
    select = torch.tensor([[1, 2]])
    near = check.near_ties([{"class_prob": first}, {"class_prob": later}],
                           select, {"MULTI_PERSON.THRESHOLD": t})
    assert near.tolist() == [True, False, True, False]


def test_window_quarters():
    assert stats.quarters([0.1, 0.2, 2.6, 3.99, 4.5], 2, 4.0) == [4, 0, 2, 4]
