"""The port's CLIs with the MvP baseline (TRANSFORMER=
multi_view_pose_transformer) on configs/synthetic_smoke.yaml's toy width,
on the CPU: `run.train` takes 1 step and writes a checkpoint that reads
back with torch.load(..., weights_only=True) into the MvP model;
`run.validate` evaluates that checkpoint, and skips the debug overlays
(DEBUG.VISUALIZATION_JUMP_NUM), which the MvP model has none of, as the
JAX package's CLI does."""

import os
import signal

import numpy as np
import pytest
import torch

from mvgformer_tpu_torch.config import load_config
from mvgformer_tpu_torch.models import build_model
from mvgformer_tpu_torch.models.mvp_decoder import MvPTransformer
from mvgformer_tpu_torch.run import train as train_cli
from mvgformer_tpu_torch.run import validate as validate_cli
from torch_one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "synthetic_smoke.yaml")
MVP = ["TRANSFORMER=multi_view_pose_transformer",
       "DECODER.projattn_posembed_mode=use_rayconv",
       "DATASET.MAX_DATA_NUM=4"]


@pytest.fixture
def restore_signals():
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


def test_mvp_train_then_validate(tmp_path, restore_signals):
    out = str(tmp_path)
    result = train_cli.main(["--cfg", SMOKE, "--max_steps", "1",
                             "--device", "cpu", f"OUTPUT_DIR={out}"] + MVP)
    assert result["steps"] == 1
    losses = result["step_losses"][0]
    assert np.isfinite(list(losses.values())).all()
    assert not any("2d" in k for k in losses)
    payload = torch.load(os.path.join(result["ckpt_dir"], "0.pt"),
                         weights_only=True)
    assert payload["step"] == 1
    cfg = load_config(SMOKE, MVP)
    model = build_model(cfg, device="cpu")
    assert isinstance(model, MvPTransformer)
    model.load_state_dict(payload["model"])

    res = validate_cli.main(["--cfg", SMOKE, "--model_path",
                             result["ckpt_dir"], "--device", "cpu",
                             f"OUTPUT_DIR={out}",
                             "DEBUG.VISUALIZATION_JUMP_NUM=1"] + MVP)
    (thr, r), = res.items()
    assert r["loop"]["frames"] == 4
    assert r["metrics"] == result["evals"][0]["metrics"]
