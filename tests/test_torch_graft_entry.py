"""The port's graft entry points (mvgformer_tpu_torch/graft_entry.py), the
counterparts of the root __graft_entry__.py, on the CPU:

  * `entry(device="cpu")` returns the flagship forward and its arguments at
    the flagship shapes (5 views at 960x512, 1024 queries x 15 joints, 4
    decoder layers), without running the forward;
  * `dryrun_multichip(2, "cpu")` (2 data ranks) and `dryrun_multichip(4,
    "cpu")` (a 2 x 2 data x view grid) run one training step and one eval
    step on gloo CPU ranks spawned by `parallel.spawn`; the step's total
    equals the port's one-process step on the same global batch to rtol
    1e-5, and the eval pred holds a row per data rank;
  * without `device="cpu"` (or `--device cpu`) the dry run asks for the
    card and raises here before it spawns a rank.
"""

import numpy as np
import pytest
import torch

from mvgformer_tpu_torch import graft_entry
from mvgformer_tpu_torch.core.train import create_train_state, make_train_step
from mvgformer_tpu_torch.models.mvgformer import MVGFormer
from torch_one_thread import one_torch_thread  # noqa: F401


def test_entry_returns_the_flagship_forward_and_its_arguments():
    forward, (params, buffers, batch) = graft_entry.entry(device="cpu")
    assert callable(forward)
    assert tuple(batch.views.shape) == (1, 5, 512, 960, 3)
    assert batch.views.device.type == "cpu"
    assert params["instance_embedding.weight"].shape == (1024, 512)
    assert params["joint_embedding.weight"].shape == (15, 512)
    layers = {name.split(".")[2] for name in params
              if name.startswith("decoder.layers.")}
    assert layers == {"0", "1", "2", "3"}
    assert all(p.device.type == "cpu" for p in params.values())
    assert "init_reference" in buffers


def _one_process_total(n):
    """The step-1 total of one process on the dry run's global batch."""
    data_size, _ = graft_entry.dryrun_grid(n)
    cfg = graft_entry.dryrun_cfg(n)
    model = MVGFormer(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    state, tx = create_train_state(cfg, model)
    step = make_train_step(cfg, model, tx, num_replicas=n)
    _, metrics = step(state, graft_entry.dryrun_batch(cfg, data_size),
                      torch.Generator().manual_seed(cfg.TRAIN.SEED))
    return float(metrics["total"])


@pytest.mark.parametrize("n, grid", [(2, (2, 1)), (4, (2, 2))])
def test_dryrun_matches_one_process(n, grid, capsys):
    assert graft_entry.dryrun_grid(n) == grid
    out = graft_entry.dryrun_multichip(n, device="cpu")
    assert capsys.readouterr().out.splitlines()[-1] == (
        f"DRYRUN-OK on {n} cpu ranks")
    assert out["pred"].shape == (grid[0], 16, 15, 5)
    assert np.isfinite(out["pred"]).all()
    np.testing.assert_allclose(out["total"], _one_process_total(n),
                               rtol=1e-5)
    # the plain versions ran: no kernel launched on the CPU
    assert not any(out["launches"].values())


def test_dryrun_asks_for_the_card_by_default(monkeypatch):
    import mvgformer_tpu_torch.parallel as parallel

    def no_spawn(*_, **__):
        raise AssertionError("a rank was spawned before the device was "
                             "resolved")

    monkeypatch.setattr(parallel, "spawn", no_spawn)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        graft_entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        graft_entry.main(["2"])


def test_main_passes_its_ranks_and_device(monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(graft_entry, "dryrun_multichip",
                        lambda n, device: calls.append((n, device)) or {})
    monkeypatch.setenv("N_DEVICES", "6")
    graft_entry.main(["4", "--device", "cpu"])
    graft_entry.main([])
    assert calls == [(4, "cpu"), (6, "cuda")]
    assert capsys.readouterr().out.splitlines() == ["dryrun ok"] * 2
