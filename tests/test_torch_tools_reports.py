"""The port's host-side tools against the JAX package's, on the CPU:

  * ap_spread_report (mvgformer_tpu_torch/tools/ap_spread_report.py) on
    the rows of tests/test_ap_spread_report.py, each row with the
    frames/s its run measured: the same band (3.8 mm) and rule, the
    fastest config first; and its three repairs, each a case whose check
    the JAX copy (tools/ap_spread_report.py, run on the same rows) fails:
    the order follows the rows' own frames/s (a row without prints "fps:
    not measured"), the printed band is the allowance the rule grants, and
    the last epoch is seed 0's;
  * extract_bone_lengths: bone_lengths.npy and tpose.npy equal to the JAX
    tool's on the synthetic dataset;
  * bench_host_pipeline: on the same synthesized JPEGs, the decoded
    images and the warped views (native warp and cv2) equal to the JAX
    tool's code path's, and the center-crop affine within 1e-5 of JAX's
    (JAX solves it in float32, the port in float64); one run of main at 2
    frames on the CPU writes the JAX tool's summary keys;
  * verify_checkpoint: a missing path, a run with no metric row, a gate
    that fails (the port's validate CLI on a toy checkpoint) and one that
    passes (PUBLISHED_* monkeypatched), each with the JAX tool's message
    and a non-zero exit where it fails.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_ap_spread_report import ROWS
from mvgformer_tpu_torch.tools import (ap_spread_report, bench_host_pipeline,
                                       extract_bone_lengths,
                                       verify_checkpoint)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
FPS = {"jacobi_k128": 7.1, "jacobi_k64": 8.2, "jacobi_k64_ptop4": 9.3}


def base(config):
    return ap_spread_report.base_name(config)


def with_fps(rows, fps=FPS):
    return [{**r, "frames_per_s": fps.get(base(r["config"])),
             "card": "a test card"} for r in rows]


def port_report(rows):
    lines = []
    ap_spread_report.report(rows, out=lines.append)
    return "\n".join(lines)


def jax_report(rows, tmp_path):
    path = tmp_path / "rows.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    out = subprocess.run([sys.executable, os.path.join(
        TOOLS, "ap_spread_report.py"), str(path)], capture_output=True,
        text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    return out.stdout


def rule_lines(text):
    return [ln.strip() for ln in text.splitlines() if "->" in ln]


def test_spread_report_band_and_rule():
    text = port_report(with_fps(ROWS))
    assert "full spread 3.8 mm" in text
    lines = rule_lines(text)
    assert lines[0].startswith("jacobi_k64_ptop4") and "QUALIFIES" in lines[0]
    assert "9.30 fps on a test card" in lines[0]
    assert sorted(ln.split(" ")[0] for ln in lines) == [
        "jacobi_k128", "jacobi_k64", "jacobi_k64_ptop4"]


def order_follows_rows(text, rows):
    """The rule's configs in descending frames/s of their rows, those
    without any last, each without printing "fps: not measured"."""
    fps = {base(r["config"]): r.get("frames_per_s") for r in rows}
    names = [ln.split(" ")[0] for ln in rule_lines(text)]
    want = sorted(names, key=lambda c: (fps[c] is None, -(fps[c] or 0.0)))
    unmeasured = all(("fps: not measured" in ln) == (fps[ln.split(" ")[0]]
                                                      is None)
                     for ln in rule_lines(text))
    return names == want and unmeasured


def band_agrees_with_rule(text, rows):
    """Every qualifying config lies within the band the report prints."""
    line = next(ln for ln in text.splitlines() if "noise band:" in ln)
    stated = float(line.split("noise band:")[1].split()[0].lstrip("+/-"))
    mpjpe = {base(r["config"]): r["mpjpe"] for r in rows
             if r.get("seed_tag", "seed0") == "seed0"
             and r.get("epoch") == 99}
    return all(mpjpe[ln.split(" ")[0]] - mpjpe["jacobi_k128"] <= stated
               for ln in rule_lines(text) if "QUALIFIES" in ln)


def rule_applied_at_seed0_last_epoch(text):
    return "Headline rule vs k128 baseline at epoch 99" in text


def repair_rows(case):
    rows = with_fps(ROWS)
    if case == "fps_order":
        # k128 measured fastest here; k64 has no measurement
        return with_fps(ROWS, {"jacobi_k128": 9.9, "jacobi_k64_ptop4": 6.0})
    if case == "band":
        # k64 at epoch 99 lies 3.0 mm above the baseline: inside the
        # 3.8 mm band the rule grants, outside half of it (its own spread
        # over the epochs, 1.1 mm, leaves the band as it was)
        moved = {59: 228.0, 99: 229.1}
        return [{**r, "mpjpe": moved[r["epoch"]]}
                if base(r["config"]) == "jacobi_k64" else r for r in rows]
    # a re-seeded arm evaluated at an epoch seed 0 lacks
    return rows + [{"config": "seed1_jacobi_k64", "ap150": 0.006,
                    "mpjpe": 216.0, "recall500": 0.9, "epoch": 119,
                    "seed_tag": "seed1"}]


REPAIRS = {"fps_order": lambda text, rows: order_follows_rows(text, rows),
           "band": band_agrees_with_rule,
           "seed0_last_epoch": lambda text, rows:
               rule_applied_at_seed0_last_epoch(text)}


@pytest.mark.parametrize("case", list(REPAIRS))
def test_spread_report_repair(case, tmp_path):
    rows = repair_rows(case)
    check = REPAIRS[case]
    assert check(port_report(rows), rows)
    # the JAX copy's logic gets this case wrong
    assert not check(jax_report(rows, tmp_path), rows)


def test_spread_report_cli(tmp_path):
    path = tmp_path / "rows.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in ROWS))
    band, qualifying = ap_spread_report.main([str(path), "--device", "cpu"])
    assert round(band, 1) == 3.8 and "jacobi_k64_ptop4" in qualifying
    assert all("fps: not measured" in ln for ln in rule_lines(
        port_report(ROWS)))


def test_extract_bone_lengths_equals_jax(tmp_path):
    args = ["--cfg", os.path.join(REPO, "configs", "synthetic_smoke.yaml"),
            "--max_frames", "12", "DATASET.MAX_DATA_NUM=6"]
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    proc = subprocess.run(
        [sys.executable, os.path.join(TOOLS, "extract_bone_lengths.py"),
         *args, "--out", str(jax_out)], capture_output=True, text=True,
        cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    extract_bone_lengths.main(args + ["--out", str(port_out), "--device",
                                      "cpu"])
    for name, shape in (("bone_lengths.npy", (14,)), ("tpose.npy", (15, 3))):
        want, got = np.load(jax_out / name), np.load(port_out / name)
        assert got.shape == shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    return bench_host_pipeline.make_images(str(tmp_path_factory.mktemp("j")))


def test_bench_host_pipeline_views_equal_jax(jpegs):
    sys.path.insert(0, TOOLS)
    import bench_host_pipeline as jax_bench
    from mvgformer_tpu import runtime as jax_runtime
    from mvgformer_tpu.data import datasets as jax_datasets
    from mvgformer_tpu_torch import runtime

    aff = np.stack([bench_host_pipeline.center_affine()] * 5)
    jaff = np.stack([jax_bench.center_affine()] * 5)
    np.testing.assert_allclose(aff, jaff, rtol=0, atol=1e-5)
    raw = bench_host_pipeline.decode(jpegs)
    np.testing.assert_array_equal(
        raw, np.stack([jax_datasets._load_image(p) for p in jpegs]))
    # the cv2 path, and the native warp where both packages build it
    got = bench_host_pipeline.warp(jpegs, raw, aff, native=False)
    want = np.stack([jax_datasets._load_and_warp_image(p, a, (960, 512))
                     for p, a in zip(jpegs, aff)])
    assert got.shape == (5, 512, 960, 3)
    np.testing.assert_array_equal(got, want)
    if runtime.native_available() and jax_runtime.native_available():
        np.testing.assert_array_equal(
            bench_host_pipeline.warp(jpegs, raw, aff, native=True),
            jax_runtime.warp_normalize_views(raw, aff, (960, 512)))


def test_bench_host_pipeline_main_on_cpu(jpegs, tmp_path):
    out = tmp_path / "summary.jsonl"
    summary = bench_host_pipeline.main(["--frames", "2", "--threads", "1",
                                        "--device", "cpu", "--out",
                                        str(out)])
    assert set(summary) == {"bench", "raw_wh", "net_wh", "views",
                            "native_warp", "device", "stage_ms",
                            "frames_per_s_by_threads"}
    assert summary["device"] == "cpu"
    assert json.loads(out.read_text()) == json.loads(json.dumps(summary))


class FakeRun:
    """subprocess.run standing in for the validate CLI."""

    def __init__(self, stdout, returncode=0):
        self.calls = []
        self.result = subprocess.CompletedProcess([], returncode, stdout, "")

    def __call__(self, cmd, **kwargs):
        self.calls.append(cmd)
        return self.result


def verify(argv, monkeypatch, fake=None):
    if fake is not None:
        monkeypatch.setattr(verify_checkpoint.subprocess, "run", fake)
    try:
        verify_checkpoint.main(argv)
    except SystemExit as e:
        return e.code
    return 0


def test_verify_checkpoint_missing_path(tmp_path, monkeypatch):
    code = verify(["--model_path", str(tmp_path / "none.pth.tar"),
                   "--data_root", str(tmp_path), "--device", "cpu"],
                  monkeypatch)
    assert code == f"missing checkpoint: {tmp_path / 'none.pth.tar'}"


def test_verify_checkpoint_no_metric_rows(tmp_path, monkeypatch):
    fake = FakeRun("eval loop: 2 frames in 1.0 s (2.0 frames/s)\n")
    code = verify(["--model_path", str(tmp_path), "--data_root",
                   str(tmp_path), "--device", "cpu"], monkeypatch, fake)
    assert code == "no metric rows found in validate.py output"
    cmd = fake.calls[0]
    assert cmd[1:3] == ["-m", "mvgformer_tpu_torch.run.validate"]
    assert cmd[cmd.index("--cfg") + 1] == verify_checkpoint.CFG
    assert "--device" in cmd and f"DATASET.ROOT={tmp_path}" in cmd


def test_verify_checkpoint_gate_passes(tmp_path, monkeypatch, capsys):
    fake = FakeRun("thr=0.1  {'ap@25': 0.5, 'mpjpe': 40.0}\n"
                   "thr=0.3  {'ap@25': 0.6, 'mpjpe': 30.0}\n")
    monkeypatch.setattr(verify_checkpoint, "PUBLISHED_AP25", 60.0)
    monkeypatch.setattr(verify_checkpoint, "PUBLISHED_MPJPE", 30.0)
    code = verify(["--model_path", str(tmp_path), "--data_root",
                   str(tmp_path), "--device", "cpu"], monkeypatch, fake)
    assert code == 0
    assert "FIDELITY GATE PASSED" in capsys.readouterr().out


def test_verify_checkpoint_gate_fails_through_validate(tmp_path, monkeypatch,
                                                       capsys):
    """The port's validate CLI on a one-step toy checkpoint: its metrics
    are far from the published numbers."""
    from mvgformer_tpu_torch.run import train as train_cli

    smoke = os.path.join(REPO, "configs", "synthetic_smoke.yaml")
    args = ["--cfg", smoke, "--device", "cpu", f"OUTPUT_DIR={tmp_path}",
            "DATASET.MAX_DATA_NUM=2"]
    ckpt = train_cli.main(args + ["--max_steps", "1"])["ckpt_dir"]
    code = verify(["--model_path", ckpt, "--data_root", str(tmp_path),
                   "--cfg", smoke, "--device", "cpu",
                   f"OUTPUT_DIR={tmp_path}", "DATASET.MAX_DATA_NUM=2"],
                  monkeypatch)
    assert code == "FIDELITY GATE FAILED: deviation exceeds 0.5%"
    assert "best row: AP25" in capsys.readouterr().out
