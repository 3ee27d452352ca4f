"""What a run may load and where it may run: no JAX and no JAX package in
a run's process, no port in the reference, no result without a card."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from harness_toy import CHECKOUT

from benchmark import run

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
