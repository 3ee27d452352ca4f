"""The reader of the DLT backward kernel's counter
(`metrics/dlt_bwd_launches_per_step.train.py`) on synthetic records: what
it reads, and nothing where the counter did not move (a program whose
training runs the plain chain, or a serving record)."""

from __future__ import annotations

from harness_toy import CHECKOUT  # noqa: F401

from benchmark import run  # noqa: E402

NAME = "dlt_bwd_launches_per_step.train"

# two traced training steps through 4 decoder layers under remat
TRAIN = {"steps": 2, "step_s": 0.4, "window_s": 1.1,
         "counters": {"dlt_jacobi.backward_launches": 8,
                      "fused_dlt.launches": 16}}


def reader():
    return run.module_at(run.HERE / "metrics" / f"{NAME}.py")


def test_launches_per_step():
    assert reader().read(TRAIN) == 4.0
    one = dict(TRAIN, steps=1, counters={"dlt_jacobi.backward_launches": 4})
    assert reader().read(one) == 4.0


def test_nothing_where_nothing_moved():
    # the parent's program: training on the plain chain, no such counter
    parent = dict(TRAIN, counters={"fused_dlt.plain_calls": 16})
    assert reader().read(parent) is None
    bare = {k: v for k, v in TRAIN.items() if k != "counters"}
    assert reader().read(bare) is None
    # a serving record has frames, not steps
    serving = {"frames": 3, "counters": {"dlt_jacobi.backward_launches": 0,
                                         "fused_dlt.launches": 12}}
    assert reader().read(serving) is None
