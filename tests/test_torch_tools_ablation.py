"""The port's AP-ablation driver and the tools' device rule, on the CPU:

  * one row (jacobi_dense) of `ap_ablation`'s eval matrix through
    `eval_config` on the CPU: the fast trainer's checkpoint at toy widths
    (one step), the row through the port's validate CLI in a subprocess,
    parsed into a row with the JAX tool's fields plus frames_per_s (the
    CLI's own eval loop) and the device, appended to the results file; a
    validate run that fails gives no row and appends nothing;
  * ap_eval_driver: 'warm' writes to the warm file, 'final' to the table;
  * every tool (ap_train_fast, ap_ablation, ap_eval_driver,
    ap_spread_report, extract_bone_lengths, verify_checkpoint,
    bench_host_pipeline) defaults to the card and raises without one.
"""

import json
import os
import subprocess

import pytest

from mvgformer_tpu_torch.config import load_config
from mvgformer_tpu_torch.tools import (ap_ablation, ap_eval_driver,
                                       ap_spread_report, ap_train_fast,
                                       bench_host_pipeline,
                                       extract_bone_lengths,
                                       verify_checkpoint)
from torch_one_thread import one_torch_thread  # noqa: F401

TOY = ["NETWORK.IMAGE_SIZE=[96,64]", "DECODER.d_model=32",
       "DECODER.dim_feedforward=64", "DECODER.nhead=4",
       "DECODER.dec_n_points=2", "DECODER.num_decoder_layers=2",
       "DECODER.num_instance=16", "POSE_RESNET.NUM_DECONV_FILTERS=[32,32,32]",
       "DATASET.CAMERA_NUM=3", "MULTI_PERSON.MAX_PEOPLE_NUM=4",
       "PARALLEL.COMPUTE_DTYPE=float32", "DATASET.MAX_DATA_NUM=2",
       "TEST.BATCH_SIZE=2"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ablation"))
    cfg = load_config(ap_ablation.CFG, TOY + ["DATASET.MAX_DATA_NUM=1",
                                               "TRAIN.END_EPOCH=1"])
    result = ap_train_fast.train(cfg, out, "cpu", log=lambda msg: None)
    assert result["steps"] == 1
    return out


def test_eval_one_row_on_cpu(trained, tmp_path):
    results = str(tmp_path / "rows.jsonl")
    overrides = dict(ap_ablation.matrix())["jacobi_dense"]
    ap_ablation.eval_config("jacobi_dense", overrides,
                            ap_ablation.find_checkpoint(trained),
                            results=results, out_dir=trained, device="cpu",
                            common=TOY)
    with open(results) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 1
    row = rows[0]
    assert set(row) == {"config", "ap25", "ap50", "ap100", "ap150", "mpjpe",
                        "recall500", "wall_s", "frames_per_s", "launches",
                        "device", "card"}
    assert row["config"] == "jacobi_dense"
    assert (row["device"], row["card"]) == ("cpu", "cpu")
    assert row["frames_per_s"] > 0 and row["mpjpe"] > 0
    # the CPU runs the kernels' plain versions
    assert row["launches"] == {"deform_sample": 0, "window_block_matmul": 0,
                               "window_block_dma": 0}
    assert 0.0 <= row["ap25"] <= 1.0


def test_a_failed_validate_run_gives_no_row(tmp_path, monkeypatch, capsys):
    def failing(*args, **kwargs):
        return subprocess.CompletedProcess(args, 1, stdout="",
                                           stderr="Traceback: boom")

    monkeypatch.setattr(ap_ablation, "run_validate", failing)
    results = tmp_path / "rows.jsonl"
    row = ap_ablation.eval_config("jacobi_dense", [], "ckpt",
                                  results=str(results), device="cpu")
    assert row is None and not results.exists()
    assert "[jacobi_dense] FAILED" in capsys.readouterr().out


def test_matrix_has_the_jax_rows():
    names = [n for n, _ in ap_ablation.matrix()]
    assert len(names) == 13 and len(set(names)) == 13
    windowed = [n for n, _ in ap_ablation.matrix(windowed=True)]
    assert len(windowed) == 17 and set(names) < set(windowed)


@pytest.mark.parametrize("phase", ["warm", "final"])
def test_eval_driver_phases_choose_the_file(phase, monkeypatch):
    got = {}
    monkeypatch.setattr(ap_ablation, "evaluate",
                        lambda **kwargs: got.update(kwargs))
    ap_eval_driver.main([phase, "--device", "cpu"])
    want = (ap_eval_driver.WARM_RESULTS if phase == "warm"
            else ap_ablation.RESULTS)
    assert got["results"] == want and os.path.basename(want).startswith(
        "torch_ap_ablation_results")


TOOL_ARGS = {
    ap_train_fast: [],
    ap_ablation: ["eval"],
    ap_eval_driver: ["final"],
    ap_spread_report: ["rows.jsonl"],
    extract_bone_lengths: ["--cfg", ap_ablation.CFG],
    verify_checkpoint: ["--model_path", "m.pth.tar", "--data_root", "d"],
    bench_host_pipeline: [],
}


@pytest.mark.parametrize("tool", list(TOOL_ARGS),
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_tools_default_to_the_card(tool):
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tool.main(TOOL_ARGS[tool])


def test_parse_row_reads_nan_and_the_cli_lines():
    """A metric line with nan (an MPJPE over no matched pose) parses; the
    frames/s and kernel counts come from the CLI's own lines."""
    out = ("eval loop: 8 frames in 2.000 s (4.000 frames/s), prefetch wait "
           "0.1 s\nkernel launches: {'deform_sample': 32, "
           "'window_block_matmul': 0, 'window_block_dma': 0}\n"
           "thr=0.1  {'ap@25': 0.0, 'ap@50': 0.0, 'mpjpe': nan, "
           "'recall@500': 0.5}\n")
    row = ap_ablation.parse_row("jacobi_dense", out)
    assert row["frames_per_s"] == 4.0 and row["recall500"] == 0.5
    assert row["mpjpe"] != row["mpjpe"]  # nan
    assert row["launches"]["deform_sample"] == 32
    assert ap_ablation.parse_row("x", "no metrics here") is None
