"""The readers of point-top-m's span and counter
(`metrics/point_topm_device_ms.serve.py`,
`metrics/point_topm_launches_per_frame.serve.py`) on synthetic records:
what they read, and nothing where the span or the counter did not move (a
model without point-top-m, or a program that has neither)."""

from __future__ import annotations

import pytest

from harness_toy import CHECKOUT  # noqa: F401

from benchmark import run, spans  # noqa: E402

DEVICE_MS = "point_topm_device_ms.serve"
LAUNCHES = "point_topm_launches_per_frame.serve"

# two traced batches of 8 frames through 4 decoder layers
BATCH8 = {"frames": 16, "frame_s": 0.021, "window_s": 0.34,
          "spans": {"mvg.projattn": {"ops": 2500, "device_s": 0.02},
                    "mvg.point_topm": {"ops": 8, "device_s": 0.0016},
                    "mvg.project": {"ops": 456, "device_s": 0.003},
                    "mvg.pred": {"ops": 10, "device_s": 0.0001}},
          "counters": {"point_topm.launches": 8, "fused_dlt.launches": 8}}


def reader(name):
    return run.module_at(run.HERE / "metrics" / f"{name}.py")


def test_device_ms_per_frame():
    assert reader(DEVICE_MS).read(BATCH8) == pytest.approx(0.1)


def test_launches_per_frame():
    assert reader(LAUNCHES).read(BATCH8) == 0.5
    live = dict(BATCH8, frames=3, counters={"point_topm.launches": 12})
    assert reader(LAUNCHES).read(live) == 4.0


@pytest.mark.parametrize("name", [DEVICE_MS, LAUNCHES])
def test_nothing_where_nothing_moved(name):
    # the parent's program: neither the span nor the counter
    parent = dict(BATCH8, spans={k: v for k, v in BATCH8["spans"].items()
                                 if k != "mvg.point_topm"},
                  counters={"fused_dlt.launches": 8})
    assert reader(name).read(parent) is None
    bare = {k: v for k, v in BATCH8.items()
            if k not in ("spans", "counters")}
    assert reader(name).read(bare) is None


@pytest.mark.parametrize("prefix", ["mvg.projattn", "mvg.project",
                                    "mvg.pred"])
def test_the_span_is_read_by_no_other_prefix(prefix):
    """The older readers match spans by the prefix of their names: none of
    theirs matches point-top-m's span."""
    point_topm = BATCH8["spans"]["mvg.point_topm"]
    assert all(e is not point_topm for e in spans.spanned(BATCH8, prefix))
