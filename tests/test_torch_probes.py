"""The ported probes (mvgformer_tpu_torch/tools/probes/) on the CPU at toy
shapes: each main runs every variant through the wrappers (the plain
versions here), holds each against its plain version, reports no time (the
CPU gives none), and refuses to run without a card unless asked for the
CPU. Importing a probe module runs nothing."""

import importlib

import numpy as np
import pytest

PROBES = ("probe_pallas_gather", "probe_pallas_gather2",
          "probe_mosaic_gather_forms", "probe_onehot_parts",
          "probe_sorted_gather_parts", "probe_table_kernel_forms")
KERNELS = {
    "probe_pallas_gather": {"row_gather", "take_along"},
    "probe_pallas_gather2": {"row_gather", "take_along", "scale"},
    "probe_mosaic_gather_forms": {"row_gather", "take_along"},
    "probe_onehot_parts": {"window_gather", "gather_reduce_forward"},
    "probe_sorted_gather_parts": {"window_gather", "row_gather"},
    "probe_table_kernel_forms": {"build_corner_table", "table_slots"},
}


def _module(name):
    return importlib.import_module(f"mvgformer_tpu_torch.tools.probes.{name}")


@pytest.mark.parametrize("name", PROBES)
def test_probe_main_runs_on_the_cpu(name, capsys):
    results = _module(name).main(["--toy"], device="cpu")
    assert results and all(r["device"] == "cpu" for r in results)
    assert {r["kernel"] for r in results if r["kernel"]} == KERNELS[name]
    # no time is taken on the CPU
    for r in results:
        assert all(r.get(k) is None for k in ("ms", "library_ms",
                                              "plain_ms")), r
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == len(results)


@pytest.mark.parametrize("name", PROBES)
def test_probe_defaults_to_the_card(name):
    main = _module(name).main
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main(["--toy"])


def test_probe_runs_only_the_variants_asked_for():
    mod = _module("probe_table_kernel_forms")
    results = mod.main(["--toy", "d2", "a_small"], device="cpu")
    assert [r["variant"] for r in results] == ["d2", "a_small"]
    assert results[0]["equals_b2"] is True
    with pytest.raises(SystemExit):
        mod.main(["--toy", "no_such_form"], device="cpu")


def test_production_like_indices_follow_the_tpu_probe():
    """The same formula as the TPU probe's (rows y * 242 + x on the
    (130, 242) grid, P points around each query); the port draws them from
    a numpy generator."""
    mod = _module("probe_sorted_gather_parts")
    idx = mod.production_like_indices(np.random.default_rng(0), 3, 4000)
    assert idx.shape == (3, 4000) and idx.dtype == np.int32
    y, x = idx // 242, idx % 242
    assert idx.min() >= 0 and y.max() <= 129 and x.max() <= 241
    # the P = 4 points of a query lie near each other
    spread = np.ptp(idx.reshape(3, 1000, 4) // 242, axis=-1)
    assert np.median(spread) <= 12


def test_sorted_block_spans_are_reported():
    results = _module("probe_sorted_gather_parts").main(
        ["--toy", "spans"], device="cpu")
    spans = {r["variant"]: r for r in results}
    assert set(spans) == {"sorted_block_span_BS512",
                          "sorted_block_span_BS1024",
                          "sorted_block_span_BS2048"}
    p50 = [spans[f"sorted_block_span_BS{b}"]["p50"]
           for b in (512, 1024, 2048)]
    assert p50 == sorted(p50)
