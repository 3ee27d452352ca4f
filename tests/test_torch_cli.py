"""The port's CLIs (mvgformer_tpu_torch/run/) on the CPU, and its shared
eval loop against the JAX package's.

  * `run.train --max_steps 2` then `run.validate` with that checkpoint, on
    configs/synthetic_smoke.yaml with --device cpu, in-process through
    main(argv): the logged "eval epoch 0" and mpjpe, the checkpoint, the
    saved preds, the prediction cache; resume; `python -m` in a
    subprocess; --device cuda without a card raises, and so do the debug
    dumps without matplotlib.
    Template: tests/test_cli_smoke.py;
  * the slice as a whole: core.infer.evaluate_dataset (batches -> eval
    step -> preds by frame index -> pose NMS -> SyntheticDataset.evaluate)
    against JAX's make_eval_step -> apply_pose_nms ->
    SyntheticDataset.evaluate on 4 rendered frames, the weights carried
    across by port_state_dict_from_jax: preds at the golden classes (3D
    p99 < 2 mm, max < 6 mm; scores rtol 1e-3), the same poses kept by NMS,
    and then the same AP and recall and MPJPE within 2 mm.
"""

import glob
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import make_golden  # noqa: E402

from mvgformer_tpu.core.nms import apply_pose_nms as jax_nms  # noqa: E402
from mvgformer_tpu.core.train import make_eval_step as jax_make_eval_step  # noqa: E402
from mvgformer_tpu.data.datasets import SyntheticDataset as JSynthetic  # noqa: E402
from mvgformer_tpu.models.mvgformer import MVGFormer as JMVGFormer  # noqa: E402
from mvgformer_tpu_torch.core.infer import (evaluate_dataset,  # noqa: E402
                                            make_eval_step, nms_evaluate)
from mvgformer_tpu_torch.core.nms import nearby_joints_nms  # noqa: E402
from mvgformer_tpu_torch.data.datasets import SyntheticDataset  # noqa: E402
from mvgformer_tpu_torch.models.mvgformer import MVGFormer  # noqa: E402
from mvgformer_tpu_torch.run import train as train_cli  # noqa: E402
from mvgformer_tpu_torch.run import validate as validate_cli  # noqa: E402
from mvgformer_tpu_torch.utils.jax_convert import port_state_dict_from_jax  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "synthetic_smoke.yaml")
THRESHOLD = 0.1


@pytest.fixture
def restore_signals():
    """The train CLI's PreemptionGuard installs SIGTERM / SIGINT handlers;
    put the test process's back."""
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


def _log(out_dir, phase):
    logs = glob.glob(os.path.join(out_dir, "synthetic", "synthetic_smoke",
                                  f"*_{phase}.log"))
    assert logs, os.listdir(out_dir)
    return "".join(open(p).read() for p in logs)


def test_train_then_validate_on_the_cpu(tmp_path, restore_signals):
    out = str(tmp_path)
    result = train_cli.main(["--cfg", SMOKE, "--max_steps", "2",
                             "--device", "cpu", f"OUTPUT_DIR={out}"])
    assert result["steps"] == 2 and len(result["step_losses"]) == 2
    assert all(np.isfinite(list(s.values())).all()
               for s in result["step_losses"])
    log = _log(out, "train")
    assert "eval epoch 0" in log and "mpjpe" in log
    ckpt_dir = result["ckpt_dir"]
    payload = torch.load(os.path.join(ckpt_dir, "0.pt"), weights_only=True)
    assert payload["step"] == 2 and payload["meta"]["epoch"] == 1

    preds = str(tmp_path / "preds.npy")
    res = validate_cli.main(["--cfg", SMOKE, "--model_path", ckpt_dir,
                             "--save_preds", preds, "--device", "cpu",
                             f"OUTPUT_DIR={out}", "TEST.PRED_FILE=cache"])
    log = _log(out, "validate")
    assert "mpjpe" in log and "summary:" in log
    saved = np.load(str(tmp_path / f"preds-{THRESHOLD}.npy"))
    assert saved.shape == (16, 16, 15, 5)  # 16 frames, 16 queries
    assert res[THRESHOLD]["loop"]["frames"] == 16
    # the same metrics as the train CLI's eval of the same weights
    assert res[THRESHOLD]["metrics"] == result["evals"][0]["metrics"]
    # the second run reads the prediction cache
    again = validate_cli.main(["--cfg", SMOKE, "--model_path", ckpt_dir,
                               "--device", "cpu", f"OUTPUT_DIR={out}",
                               "TEST.PRED_FILE=cache"])
    assert again[THRESHOLD]["loop"] is None
    assert again[THRESHOLD]["metrics"] == res[THRESHOLD]["metrics"]

    # resume: the next epoch starts from the checkpoint (END_EPOCH 2)
    resumed = train_cli.main(["--cfg", SMOKE, "--max_steps", "1",
                              "--device", "cpu", f"OUTPUT_DIR={out}",
                              "TRAIN.RESUME=true", "TRAIN.END_EPOCH=2"])
    assert resumed["steps"] == 1
    assert resumed["evals"][0]["epoch"] == 1
    assert torch.load(os.path.join(ckpt_dir, "1.pt"),
                      weights_only=True)["step"] == 3


def test_validate_as_a_module(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "mvgformer_tpu_torch.run.validate", "--cfg",
         SMOKE, "--device", "cpu", f"OUTPUT_DIR={tmp_path}",
         "DATASET.MAX_DATA_NUM=2", "DATASET.CAMERA_DETAIL=true"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "mpjpe" in proc.stderr and "obs>=" in proc.stderr


def test_no_card_and_debug_dumps_raise(tmp_path, restore_signals,
                                       monkeypatch):
    """Without a card the CLIs raise; the debug dumps
    (DEBUG.VISUALIZATION_JUMP_NUM >= 0) raise ImportError without
    matplotlib, as JAX's do, rather than skip the plots."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            validate_cli.main(["--cfg", SMOKE, f"OUTPUT_DIR={tmp_path}"])
        with pytest.raises(RuntimeError, match="no CUDA card"):
            train_cli.main(["--cfg", SMOKE, "--device", "cuda",
                            f"OUTPUT_DIR={tmp_path}"])
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        validate_cli.main(["--cfg", SMOKE, "--device", "cpu",
                           f"OUTPUT_DIR={tmp_path}", "DATASET.MAX_DATA_NUM=1",
                           "DEBUG.VISUALIZATION_JUMP_NUM=1"])


def test_eval_loop_matches_jax():
    cfg = make_golden.toy_cfg(topk=8, solver="eigh")
    cfg.DATASET.MAX_DATA_NUM = 4
    # a 4 x 4 m space puts some of the 16 queries' random-weight poses
    # within 500 mm of a person, so the match and MPJPE are exercised
    cfg.MULTI_PERSON.SPACE_SIZE = [4000.0, 4000.0, 2000.0]
    jds = JSynthetic(cfg, "validation", is_train=False)
    jm = JMVGFormer(cfg=cfg)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 jds.load_batch([0, 1]))
    jstep = jax.jit(jax_make_eval_step(cfg, jm, THRESHOLD))
    want_preds = []
    for _, batch in jds.batches(3, shuffle=False, drop_last=False):
        want_preds.append(np.asarray(jstep(variables["params"],
                                           variables["batch_stats"], batch)))
    want_preds = list(np.concatenate(want_preds)[:4])
    want_nmsed = [jax_nms(p) for p in want_preds]
    want = jds.evaluate(want_nmsed)

    variables = jax.tree_util.tree_map(np.asarray, variables)
    model = MVGFormer(cfg, device="cpu")
    model.load_state_dict(port_state_dict_from_jax(variables, cfg))
    ds = SyntheticDataset(cfg, "validation", is_train=False)
    got, run = evaluate_dataset(ds, make_eval_step(cfg, model, THRESHOLD),
                                3, "cpu")
    assert len(run.preds) == 4  # the padding of the second batch dropped
    for p, w in zip(run.preds, want_preds):
        err = np.abs(p[..., :3] - w[..., :3])
        assert np.percentile(err, 99) < 2.0 and err.max() < 6.0
        np.testing.assert_allclose(p[..., 4], w[..., 4], rtol=1e-3,
                                   atol=1e-4)
        clear = np.abs(w[..., 4] - THRESHOLD) > 1e-4
        np.testing.assert_array_equal(p[..., 3][clear], w[..., 3][clear])
        flagged, wflagged = p[p[:, 0, 3] >= 0], w[w[:, 0, 3] >= 0]
        assert len(flagged) == len(wflagged) > 0
        assert (list(nearby_joints_nms(flagged, 0.3, 7))
                == list(nearby_joints_nms(wflagged, 0.3, 7)))
    assert set(got) == set(want)
    assert 0 < want["recall@500"] and np.isfinite(want["mpjpe"])
    # on JAX's own preds, the port's NMS and metrics give JAX's, exactly
    assert nms_evaluate(ds, want_preds) == want
    for k in want:
        if k == "mpjpe":
            assert abs(got[k] - want[k]) < 2.0, (got[k], want[k])
        else:
            assert got[k] == want[k], k
