"""What a run may load and where it may run: no JAX and no JAX package in
a run's process, no port in the reference, no result without a card."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import types

import pytest

from harness_toy import CHECKOUT

from benchmark import run, spans

FORBIDDEN_REFERENCE = ("jax", "jaxlib", "flax", "mvgformer_tpu",
                       "mvgformer_tpu_torch")


@pytest.mark.parametrize("config", ["mvgformer_panoptic5", "mvp_panoptic5"])
def test_a_run_loads_no_jax(config):
    env = dict(os.environ, PYTHONPATH=str(CHECKOUT))
    out = subprocess.run(
        [sys.executable, str(CHECKOUT / "benchmark" / "tests"
                             / "harness_toy.py"), config],
        capture_output=True, text=True, env=env, timeout=600, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert got["forbidden"] == []
    assert not set(got["modules"]) & set(run.FORBIDDEN)


def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(
    (CHECKOUT / "benchmark" / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_neither_jax_nor_the_port(path):
    for name in imports(path):
        assert name.split(".")[0] not in FORBIDDEN_REFERENCE, name


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH="")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "dq_serve_live_b1", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, env=env, cwd=CHECKOUT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def finished_run(*args, **kwargs):
    """A cell's run as `run.run_cell` returns it, with spans in its record."""
    record = {"spans": {"mvg.step": {"ops": 3, "idle_s": 0.002}},
              "unspanned": {"ops": 1, "idle_s": 0.001}, "frames": 1}
    result = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
              "device": {"platform": "gpu"},
              "checks": {"score_gap": {"value": 0.001, "limit": 0.01}}}
    return {"record": record, "result": result}


@pytest.mark.parametrize("loaded", [True, False], ids=["jax", "none"])
@pytest.mark.parametrize("entry", ["benchmark.run", "benchmark.spans"])
def test_forbidden_module_no_result(entry, loaded, monkeypatch, capsys):
    """Either entry prints no result and exits 3 where JAX is loaded once
    the run has ended, and prints its result where nothing is."""
    main = (run.main if entry == "benchmark.run" else spans.main)
    monkeypatch.setattr(run, "cache_dirs", lambda: None)
    monkeypatch.setattr(run, "require_cards", lambda count: None)
    monkeypatch.setattr(run, "run_cell", finished_run)
    for name in run.forbidden_modules():
        monkeypatch.delitem(sys.modules, name)
    if loaded:
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = main(["--workload", "dq_serve_live_b1", "--seed", str(2 ** 31 + 9),
               "--seconds", "1"])
    out = capsys.readouterr()
    if loaded:
        assert rc == 3
        assert out.out.strip() == ""
        assert "loaded in the run: jax" in out.err
    else:
        assert rc == 0
        assert json.loads(out.out.strip().splitlines()[-1])["correct"]


@pytest.mark.parametrize("path", sorted(
    p for p in (CHECKOUT / "benchmark").rglob("*.py")
    if "tests" not in p.parts and p.name != "program.py"),
    ids=lambda p: str(p.relative_to(CHECKOUT / "benchmark")))
def test_only_program_imports_the_port(path):
    for name in imports(path):
        assert name.split(".")[0] not in FORBIDDEN_REFERENCE, name
