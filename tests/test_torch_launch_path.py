"""The kernel wrappers' shared launch path (`ops/_build.py::Launcher`) and
the launch-cost tool, on the CPU: every wrapper module launches through a
Launcher whose last argument is the stream, built and bound only at its
first call; each source's nvcc flags; the choice between the sampling
kernels' vector and generic instances (`vector_width`); the probe wrappers'
device check; and the tool refuses to run without a card.
"""

import ctypes
from pathlib import Path

import pytest
import torch

from mvgformer_tpu_torch.ops import (_build, deform_attn, dlt_jacobi,
                                     gather_forms, point_topm, table_build,
                                     table_gather, window_block, window_dma)

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
    "table_slots": table_build._BUILD,  # B2's kernel with a slot map
    "noop": gather_forms._NOOP,
    "dlt_jacobi": dlt_jacobi._LAUNCH,
    "point_topm": point_topm._LAUNCH,
}


@pytest.mark.parametrize("name", sorted(LAUNCHERS))
def test_every_wrapper_launches_through_a_launcher(name):
    launcher = LAUNCHERS[name]
    assert isinstance(launcher, _build.Launcher)
    assert launcher.src.parent == _build.CSRC and launcher.src.is_file()
    assert launcher.name in launcher.src.read_text()
    assert launcher.argtypes[-1] is ctypes.c_void_p  # the stream


@pytest.mark.parametrize("src", sorted(p.name for p in
                                       _build.CSRC.glob("*.cu")))
def test_nvcc_flags_per_source(src):
    """Every source takes the shared flags; only the DLT, which rounds
    where the plain torch chain does, also turns off fused multiply-adds,
    and its flags are part of its library's name."""
    path = _build.CSRC / src
    flags = _build.flags(path)
    assert flags[:len(_build.NVCC_FLAGS)] == _build.NVCC_FLAGS
    extra = flags[len(_build.NVCC_FLAGS):]
    assert extra == (("-fmad=false",) if src == "dlt_jacobi.cu" else ())


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


@pytest.mark.parametrize("dtype,esize", [(torch.float32, 4),
                                         (torch.bfloat16, 2)])
@pytest.mark.parametrize("D", [32, 40, 8, 6, 4, 1])
@pytest.mark.parametrize("offset", [0, 1, 8])
def test_vector_width(dtype, esize, D, offset):
    """16-byte vectors (16 / esize elements per thread) where a row of D
    elements is whole vectors and every pointer is 16-byte aligned, else
    the generic instance's one element."""
    buf = torch.zeros(4096 + 16, dtype=dtype)
    view = buf[offset:offset + 4096]
    aligned = torch.zeros(64, dtype=dtype)
    whole = (D * esize) % 16 == 0
    on_16 = (offset * esize) % 16 == 0
    want = 16 // esize if whole and on_16 else 1
    assert _build.vector_width(D, esize, view, aligned) == want
    assert _build.vector_width(D, esize, aligned) == (16 // esize if whole
                                                      else 1)


def test_launch_cost_needs_a_card():
    from mvgformer_tpu_torch.tools import launch_cost

    with pytest.raises(SystemExit, match="CUDA"):
        launch_cost.main([])
    with pytest.raises(SystemExit):
        launch_cost.main(["--kernels", "deform,nothing"])


def _toy_cfg():
    from mvgformer_tpu_torch.config import load_config

    cfg = load_config()
    cfg.NETWORK.IMAGE_SIZE = [96, 64]
    cfg.DECODER.d_model = 32
    cfg.DECODER.nhead = 4
    cfg.DECODER.num_instance = 16
    cfg.DATASET.CAMERA_NUM = 3
    return cfg


@pytest.mark.parametrize("kernels,name", [
    ("window_block", "window_block_matmul K 28 P 4, 3 levels"),
    ("window_dma", "window_block_dma K 28 P 4, 3 levels"),
    ("table_build", "build_corner_table 3 levels")])
def test_launch_cost_window_case_on_the_cpu(kernels, name):
    """launch_cost's B4, B5 and B2 cases on a toy rig (3 views at 96x64, 4
    heads x 8): on the CPU each goes through its wrapper to the plain
    version, launches nothing and matches its `plain` bit for bit. The
    window plan keeps the flagship's K 28 (halo from the point count)."""
    from mvgformer_tpu_torch.tools import launch_cost

    repo = Path(__file__).resolve().parents[1]
    cases = launch_cost.kernel_cases(repo, torch, {kernels}, device="cpu",
                                     cfg=_toy_cfg())
    assert [c[0] for c in cases] == [name]
    wrappers = (window_block.window_block_matmul,
                window_dma.window_block_dma, table_build.build_corner_table)
    launches = [k.launches for k in wrappers]
    _, fn, plain = cases[0]
    got, want = fn(), plain()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w)
    assert launch_cost.max_abs_err(got, want) == 0.0
    assert [k.launches for k in wrappers] == launches
    assert launch_cost.kernel_cases(repo, torch, {"probes"},
                                    device="cpu") == []


def test_sampling_inputs_mix_edge_and_nonfinite_locations():
    from mvgformer_tpu_torch.tools import launch_cost

    shapes = ((16, 30), (8, 15))
    value, loc, aw = launch_cost.sampling_inputs(
        64, 4, torch.bfloat16, torch.Generator().manual_seed(0),
        levels=shapes, views=2, heads=3, head_dim=8, device="cpu")
    assert value.shape == (2, 16 * 30 + 8 * 15, 3, 8)
    assert loc.shape == (2, 64, 3, 2, 4, 2) and aw.shape == (2, 64, 3, 2, 4)
    assert value.dtype == aw.dtype == torch.bfloat16
    assert loc.dtype == torch.float32
    assert torch.isnan(loc).any() and torch.isinf(loc).any()
    assert (loc[:, 16:24] == 50.0).all()


def test_noop_needs_a_card():
    with pytest.raises(ValueError, match="card"):
        gather_forms.noop(torch.zeros(1))
    assert gather_forms.noop not in gather_forms.KERNELS  # no TPU kernel
