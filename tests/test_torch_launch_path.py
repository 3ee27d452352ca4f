"""The kernel wrappers' shared launch path (`ops/_build.py::Launcher`) and
the launch-cost tool, on the CPU: every wrapper module launches through a
Launcher whose last argument is the stream, built and bound only at its
first call; the probe wrappers' device check; and the tool refuses to run
without a card.
"""

import ctypes
from pathlib import Path

import pytest
import torch

from mvgformer_tpu_torch.ops import (_build, deform_attn, gather_forms,
                                     table_build, table_gather, window_block,
                                     window_dma)

LAUNCHERS = {
    "deform_sample": deform_attn._FORWARD,
    "window_block": window_block._FORWARD,
    "window_dma": window_dma._FORWARD,
    "table_build": table_build._BUILD,
    "table_gather_forward": table_gather._FORWARD,
    "table_gather_backward": table_gather._BACKWARD,
    "row_gather": gather_forms._ROW_GATHER,
    "take_along": gather_forms._TAKE_ALONG,
    "scale": gather_forms._SCALE,
    "table_slots": gather_forms._TABLE_SLOTS,
}


@pytest.mark.parametrize("name", sorted(LAUNCHERS))
def test_every_wrapper_launches_through_a_launcher(name):
    launcher = LAUNCHERS[name]
    assert isinstance(launcher, _build.Launcher)
    assert launcher.src.parent == _build.CSRC and launcher.src.is_file()
    assert launcher.name in launcher.src.read_text()
    assert launcher.argtypes[-1] is ctypes.c_void_p  # the stream


def test_launcher_binds_at_its_first_call_only():
    launcher = _build.Launcher(Path("no_such_source.cu"), "mvg_nothing",
                               [ctypes.c_void_p])
    assert launcher._fn is None  # nothing built or loaded yet


def test_probe_device_check():
    cpu = torch.zeros(3)
    assert gather_forms._check_device(cpu, torch.zeros(2)) == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        gather_forms._check_device(torch.zeros(3, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        gather_forms._check_device(cpu, torch.zeros(3, device="meta"))


def test_launch_cost_needs_a_card():
    from mvgformer_tpu_torch.tools import launch_cost

    with pytest.raises(SystemExit, match="CUDA"):
        launch_cost.main([])
