"""The port's CLIs with PARALLEL.DATA=2 on the CPU (two gloo ranks that
`parallel.launch` spawns), on configs/synthetic_smoke.yaml:

  * `run.train`: 2 steps over global batches of 2 frames; rank 0 alone
    writes one log and one checkpoint directory; the summary names the
    world and the backend; the checkpoint reads back;
  * `run.validate` on that checkpoint: its preds (each rank its rows of
    batches of 2, gathered by frame index, the last batch padded) equal
    the 1-rank run's bit for bit at the same per-rank batch;
  * `init_data_parallel` under torchrun's variables: the world is
    torchrun's, a PARALLEL.DATA other than -1 or that world raises, a
    world of 1 makes no group.

The ranks run one intra-op thread each (OMP_NUM_THREADS=1, as the test
process), so both runs reduce in the same order.
"""

import glob
import os
import signal

import numpy as np
import pytest
import torch

from mvgformer_tpu_torch.parallel import init_data_parallel
from mvgformer_tpu_torch.run import train as train_cli
from mvgformer_tpu_torch.run import validate as validate_cli
from torch_one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "synthetic_smoke.yaml")
THRESHOLD = 0.1


@pytest.fixture
def restore_signals():
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_train")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        result = train_cli.main(["--cfg", SMOKE, "--max_steps", "2",
                                 "--device", "cpu", f"OUTPUT_DIR={out}",
                                 "DATASET.MAX_DATA_NUM=4",
                                 "PARALLEL.DATA=2"])
    return out, result


def test_train_cli_on_two_ranks(trained):
    out, result = trained
    assert result["world"] == 2 and result["backend"] == "gloo"
    assert result["steps"] == 2
    assert all(np.isfinite(list(s.values())).all()
               for s in result["step_losses"])
    run_dir = os.path.join(out, "synthetic", "synthetic_smoke")
    logs = glob.glob(os.path.join(run_dir, "*_train.log"))
    assert len(logs) == 1, logs
    log = open(logs[0]).read()
    assert "rank 0 of 2, backend gloo" in log and "eval epoch 0" in log
    ckpts = set(os.listdir(os.path.join(run_dir, "checkpoints")))
    assert "0.pt" in ckpts and ckpts <= {"0.pt", "best"}, ckpts
    payload = torch.load(os.path.join(result["ckpt_dir"], "0.pt"),
                         weights_only=True)
    assert payload["step"] == 2


def test_validate_cli_two_ranks_equal_one(trained, tmp_path, monkeypatch,
                                          restore_signals):
    _, result = trained
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    common = ["--cfg", SMOKE, "--model_path", result["ckpt_dir"],
              "--device", "cpu", "DATASET.MAX_DATA_NUM=5"]
    two = validate_cli.main(common + [f"OUTPUT_DIR={tmp_path / 'two'}",
                                      "PARALLEL.DATA=2",
                                      "TEST.BATCH_SIZE=2"])
    one = validate_cli.main(common + [f"OUTPUT_DIR={tmp_path / 'one'}",
                                      "TEST.BATCH_SIZE=1"])
    assert (two[THRESHOLD]["world"], two[THRESHOLD]["backend"]) == (2,
                                                                    "gloo")
    assert (one[THRESHOLD]["world"], one[THRESHOLD]["backend"]) == (1, None)
    name = os.path.join("synthetic", "synthetic_smoke",
                        f"preds-{THRESHOLD}.npy")
    got = np.load(tmp_path / "two" / name)
    want = np.load(tmp_path / "one" / name)
    assert got.shape == want.shape == (5, 16, 15, 5)
    np.testing.assert_array_equal(got, want)
    assert two[THRESHOLD]["metrics"] == one[THRESHOLD]["metrics"]
    assert two[THRESHOLD]["loop"]["frames"] == 5
    # rank 1 wrote nothing
    assert len(glob.glob(str(tmp_path / "two" / "synthetic" /
                             "synthetic_smoke" / "*.log"))) == 1


def test_torchrun_world(monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="PARALLEL.DATA=3 under torchrun"):
        init_data_parallel(3, "cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    dp = init_data_parallel(-1, "cpu")
    assert (dp.rank, dp.world, dp.group, dp.backend) == (0, 1, None, None)
    assert not dp.distributed and dp.is_main


def test_data_parallel_needs_its_processes(monkeypatch):
    for var in ("RANK", "LOCAL_RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="needs its processes"):
        init_data_parallel(2, "cpu")
