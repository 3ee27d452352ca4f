"""chip_smoke.py's kernel table and ranking, on hand-made rows (CPU).

Importing chip_smoke builds nothing and touches no card. The ranking
compares a kernel with its library call on the device clock (device_ms
against library_device_ms) where both have one, else on the event clock
(ms against library_ms); the excess prices each shape's launches at that
shape's device time (or ms) less its bound.
"""

import types

import pytest

import chip_smoke
from mvgformer_tpu_torch.ops import _build
from mvgformer_tpu_torch.utils import bounds


def _fn(name):
    return types.SimpleNamespace(__name__=name)


def _work(bound_ms):
    return bounds.Work(int(round(bound_ms * 1e-3 * bounds.HBM_BYTES_PER_S)))


def _row(name, ms, library_ms=None, bound_ms=0.01, launches=10, **extra):
    return chip_smoke.kernel_row(_fn(name), "x.cu", "x.py:1", launches, 0.0,
                                 ms, 2 * ms, library_ms, _work(bound_ms),
                                 "toy", library=library_ms and "torch.x",
                                 **extra)


def test_slower_on_the_event_clock_but_not_on_the_device_is_not_slower():
    row = _row("take_along", 0.060, 0.044, device_ms=0.0119,
               library_device_ms=0.0178)
    order = chip_smoke.ranking([row])
    assert order == [{"name": "take_along", "excess_ms": row["excess_ms"]}]


def test_slower_on_the_device_is_listed_by_its_device_factor():
    row = _row("slow", 0.030, 0.040, device_ms=0.020,
               library_device_ms=0.010)
    fast = _row("fast", 0.030, 0.040, device_ms=0.005,
                library_device_ms=0.010)
    order = chip_smoke.ranking([fast, row])
    assert order[0] == {"name": "slow", "slower_than_library_by": 2.0,
                        "clock": "device_ms"}
    assert order[1]["name"] == "fast"


@pytest.mark.parametrize("device,library_device", [(None, None),
                                                   (0.01, None),
                                                   (None, 0.01)])
def test_event_clock_where_not_both_have_device_time(device, library_device):
    extra = {}
    if device is not None:
        extra["device_ms"] = device
    if library_device is not None:
        extra["library_device_ms"] = library_device
    row = _row("k", 0.060, 0.030, **extra)
    assert chip_smoke.vs_library(row) == (2.0, "ms")
    assert chip_smoke.ranking([row])[0]["clock"] == "ms"


def test_no_library_call_is_never_slower():
    row = _row("b1", 1.3, None, bound_ms=0.06, launches=24)
    assert chip_smoke.vs_library(row) is None
    assert chip_smoke.ranking([row])[0]["name"] == "b1"


def test_b1_excess_sums_its_two_shapes():
    """6 frames: 6 launches at dense layer 1, 18 at the top-64 shape, each
    priced at its own device time and bound."""
    by_shape = [
        {"at": "Lq=15360", "launches": 6, "ms": 1.40, "device_ms": 1.30,
         "bound_ms": 0.064},
        {"at": "Lq=960", "launches": 18, "ms": 0.15, "device_ms": 0.09,
         "bound_ms": 0.006},
    ]
    row = _row("deform_sample", 1.40, None, bound_ms=0.064, launches=24,
               by_shape=by_shape, device_ms=1.30)
    want = 6 * (1.30 - 0.064) + 18 * (0.09 - 0.006)
    assert row["excess_ms"] == pytest.approx(want)
    # not every launch at the layer-1 time
    assert row["excess_ms"] < 24 * (1.30 - 0.064)


def test_excess_of_a_summed_row_is_per_launch():
    row = _row("window_block_matmul", 1.8, None, bound_ms=0.2, launches=30,
               timed_launches=3, device_ms=1.5)
    assert row["excess_ms"] == pytest.approx(30 * (1.5 - 0.2) / 3)
    without = _row("window_block_dma", 1.8, None, bound_ms=0.2, launches=30,
                   timed_launches=3)
    assert without["excess_ms"] == pytest.approx(30 * (1.8 - 0.2) / 3)


def test_device_ms_prices_a_row_without_a_library_call():
    """B2's row: no library call, timed on both clocks; the excess reads
    the device clock, and the event clock's host path is not priced."""
    row = _row("build_corner_table", 0.341, None, bound_ms=0.165,
               launches=168, timed_launches=3, device_ms=0.270)
    assert chip_smoke.vs_library(row) is None
    assert row["excess_ms"] == pytest.approx(168 * (0.270 - 0.165) / 3)
    assert chip_smoke.ranking([row]) == [
        {"name": "build_corner_table", "excess_ms": row["excess_ms"]}]


def test_parent_turns_pick_the_kernels_own_case():
    turns = {"window_block_matmul K 28 P 4, 3 levels": {"parent_ms": [1]},
             "window_block_dma K 28 P 4, 3 levels": {"parent_ms": [2]},
             "build_corner_table 3 levels": {"parent_ms": [3]}}
    for name, want in (("window_block_matmul", 1), ("window_block_dma", 2),
                       ("build_corner_table", 3), ("deform_sample", None)):
        got = chip_smoke.parent_turns(turns, _fn(name))
        assert got == ({"parent_ms": [want]} if want else {})


def test_rest_ordered_by_excess():
    rows = [_row("a", 0.5, bound_ms=0.1, launches=2),
            _row("b", 0.5, bound_ms=0.1, launches=20),
            _row("c", 0.2, 0.1, bound_ms=0.1, launches=5)]
    names = [r["name"] for r in chip_smoke.ranking(rows)]
    assert names == ["c", "b", "a"]


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN46_INTERNAL_d8f1cf08e_16_deform_sample_cu_a750db1f24deform_sample_fwd_kernelI13__nv_bfloat16Li8ELi3ELi4EEEvPKT_PKfS5_PS3_iiiiiii6Levels' for 'sm_90a'
ptxas info    : Function properties for _ZN46_INTERNAL_d8f1cf08e_16_deform_sample_cu_a750db1f24deform_sample_fwd_kernelI13__nv_bfloat16Li8ELi3ELi4EEEvPKT_PKfS5_PS3_iiiiiii6Levels
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 0 barriers, 440 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123window_block_fwd_kernelIfLi1ELi0EEEvPKT_PKfPKiPS1_iiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123window_block_fwd_kernelIfLi1ELi0EEEvPKT_PKfPKiPS1_iiiiiii
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, 392 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_and_spills():
    report = _build.ptxas_report(PTXAS_LOG)
    assert report == [
        {"kernel": "deform_sample_fwd_kernel<bf16, 8, 3, 4>",
         "registers": 72, "stack_bytes": 0, "spill_store_bytes": 0,
         "spill_load_bytes": 0},
        {"kernel": "window_block_fwd_kernel<float, 1, 0>", "registers": 40,
         "stack_bytes": 8, "spill_store_bytes": 4, "spill_load_bytes": 4},
    ]


def test_instance_label_keeps_other_names():
    assert _build.instance_label("_Z3fooPf") == "_Z3fooPf"
