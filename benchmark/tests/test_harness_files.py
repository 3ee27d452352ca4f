"""BENCHMARK.json and the files it names, against the benchmark's
contract: names, units, keys, each file found by name."""

from __future__ import annotations

import ast
import json
import re

import pytest

from harness_toy import CHECKOUT

from benchmark import run

BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CELLS = {c["name"]: c for c in BENCH["workloads"]}


def test_top_level_keys_and_paths():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


def test_run_seconds_fit_the_check_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_names_units_and_one_line_fields(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_parses_and_is_used(config):
    spec = json.loads((CHECKOUT / config["file"]).read_text())
    assert config["file"] == f"benchmark/configs/{config['name']}.json"
    assert spec["reduced"] == config["reduced"]
    assert (CHECKOUT / spec["yaml"]).is_file()
    assert any(c["config"] == config["name"] for c in BENCH["workloads"])


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_every_departure_from_the_yaml_is_named(config):
    """Each setting that differs from the yaml's is listed: in `reduced`
    where the yaml is the source, in `from_source` (the source's own value)
    where the source is another model's published file."""
    from mvgformer_tpu_torch.config import load_config

    spec = json.loads((CHECKOUT / config["file"]).read_text())
    cfg = load_config(str(CHECKOUT / spec["yaml"]))
    differ = {}
    for key, value in spec["settings"].items():
        section, name = key.split(".") if "." in key else (None, key)
        have = getattr(cfg if section is None else getattr(cfg, section),
                       name)
        if json.loads(json.dumps(have)) != value:
            differ[key] = value
    named = spec.get("from_source", {})
    assert {k: v for k, v in differ.items() if k not in named} == {
        k: spec["settings"][k] for k in spec["reduced"]}
    assert all(spec["settings"][k] == v for k, v in named.items())


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell):
    traffic = json.loads((run.HERE / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    assert (run.HERE / "loops" / f"{traffic['loop']}.py").is_file()
    assert traffic["ring_frames"] % traffic["batch"] == 0
    limits = json.loads((run.HERE / "limits"
                         / f"{cell['name']}.json").read_text())
    assert limits and all(v >= 0 for v in limits.values())
    assert cell["chips"] == 1
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if run.applies(m, cell["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(run.applies(m, cell["name"]) for m in BENCH["per_layer"])


def test_end_to_end_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        for cell in m.get("workloads", []):
            assert cell in CELLS
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_reader_and_moves(metric):
    reader = run.HERE / "metrics" / f"{metric['name']}.py"
    tree = ast.parse(reader.read_text())
    assert any(isinstance(n, ast.FunctionDef) and n.name == "read"
               for n in tree.body)
    moves = next(m for m in BENCH["end_to_end"]
                 if m["name"] == metric["moves"])
    for cell in metric["workloads"]:
        assert run.applies(moves, cell), (metric["name"], cell)


def test_layers_match_perf_md():
    perf = (CHECKOUT / "PERF.md").read_text()
    for metric in BENCH["per_layer"]:
        assert metric["layer"] in perf


def test_every_reader_is_a_per_layer_entry():
    """A reader in `metrics/` that no entry lists is read by no run."""
    listed = {m["name"] for m in BENCH["per_layer"]}
    readers = {p.name[:-3] for p in (run.HERE / "metrics").glob("*.py")}
    assert readers == listed
