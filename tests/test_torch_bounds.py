"""utils/bounds.py: the compulsory bytes and operations of each kernel at
the flagship shapes, against the counts written out by hand, and the
data-dependent reads counted on small inputs whose touched rows are known.

Flagship: 5 views x 8 heads = 40 pairs, D = 32, bfloat16, levels 128x240 /
64x120 / 32x60 (value 40,320 pixels per pair); B3 at 122,880 samples per
pair and level."""

import pytest
import torch

from mvgformer_tpu_torch.utils import bounds

LEVELS = ((128, 240), (64, 120), (32, 60))


def test_b2_one_layer():
    work = bounds.total([bounds.table_build(40, h, w, 32, 2)
                         for h, w in LEVELS])
    written = 40 * (130 * 256 + 66 * 128 + 34 * 64) * 128 * 2
    assert written == 449_576_960
    read = 40 * 40_320 * 32 * 2
    assert read == 103_219_200
    assert work.bytes == written + read and work.flops == 0
    assert work.bound_by == "bytes"
    assert work.bound_ms == pytest.approx(0.16501, rel=1e-4)


def test_b3_level0_forward_and_backward():
    NH, R, S, D = 40, 130 * 256, 122_880, 32
    fwd = bounds.table_gather_forward_counts(NH, R, S, D, 2, rows=NH * R)
    tables, idx, w4, out = NH * R * 256, NH * S * 4, NH * S * 8, NH * S * 64
    assert (tables, idx, w4, out) == (340_787_200, 19_660_800, 39_321_600,
                                      314_572_800)
    assert fwd.bytes == tables + idx + w4 + out
    assert fwd.bound_ms == pytest.approx(0.2132, rel=1e-3)
    bwd = bounds.table_gather_backward_counts(NH, R, S, D, 2, rows=NH * R)
    # reads the cotangent (the size of the forward's output) and writes
    # the whole grad_tables and grad_w4
    assert bwd.bytes == fwd.bytes + tables + w4
    assert bwd.flops == 2 * fwd.flops
    assert bwd.bound_ms == pytest.approx(0.3267, rel=1e-3)


def test_b1_dense_layer_bytes_when_every_pixel_is_touched():
    """Uniform locations over every level touch every value row: the
    bytes are the value, locations, weights and output, read or written
    once."""
    N, Lq, H, D, P = 2, 600, 2, 4, 4
    shapes = ((6, 10), (3, 5))
    len_in = sum(h * w for h, w in shapes)
    value = torch.zeros(N, len_in, H, D, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    loc = torch.rand(N, Lq, H, len(shapes), P, 2, generator=gen)
    aw = torch.zeros(N, Lq, H, len(shapes), P, dtype=torch.bfloat16)
    work = bounds.deform_sample(value, shapes, loc, aw)
    assert work.bytes == (N * len_in * H * D * 2 + loc.numel() * 4
                          + aw.numel() * 2 + N * Lq * H * D * 2)
    assert work.flops == 2 * 4 * D * N * Lq * H * len(shapes) * P


def test_b1_counts_only_the_corners_inside_the_map():
    value = torch.zeros(1, 12, 1, 8)  # one level of 3 x 4, D = 8, float32
    loc = torch.full((1, 2, 1, 1, 1, 2), float("nan"))
    loc[0, 0, 0, 0, 0] = torch.tensor([0.5 / 4, 0.5 / 3])  # pixel (0, 0)
    aw = torch.ones(1, 2, 1, 1, 1)
    work = bounds.deform_sample(value, ((3, 4),), loc, aw)
    # x = y = 0 exactly: corners (0,0) (0,1) (1,0) (1,1) in the map
    assert work.bytes == 4 * 8 * 4 + loc.numel() * 4 + 2 * 4 + 2 * 8 * 4


def test_gathers_count_each_touched_row_once():
    tbl = torch.zeros(2, 10, 16, dtype=torch.bfloat16)  # 32-byte rows
    idx = torch.tensor([[1, 1, 1, 9], [0, 0, -1, 12]], dtype=torch.int32)
    work = bounds.row_gather(tbl, idx)
    # rows (0,1) (0,9) (1,0); -1 and 12 lie off the table
    assert work.bytes == 3 * 32 + idx.numel() * 4 + idx.numel() * 32
    assert bounds.table_rows_touched(tbl, idx) == 3
    base = torch.tensor([[1], [0]], dtype=torch.int32)
    local = torch.tensor([[0, 0, 1, 9], [1, 2, 3, 3]], dtype=torch.int32)
    sel = bounds.window_gather(tbl, base, local, W=6, unit=8, mode="select")
    # pair 0 rows 8, 9 (local 9 is off the window); pair 1 rows 1, 2, 3
    assert sel.bytes == 5 * 32 + 2 * 4 + 8 * 4 + 8 * 32
    zero = bounds.window_gather(tbl, base, local, W=6, unit=8, mode="zero")
    assert zero.bytes == 8 * 32


def test_take_along_and_scale():
    tbl = torch.zeros(4, 3)
    idx = torch.tensor([[0, 0, 3], [0, 1, 3]], dtype=torch.int32)
    work = bounds.take_along(tbl, idx, 0)
    # elements (0,0) (0,1) (3,2) and (1,1): (0,0) and (3,2) twice
    assert work.bytes == 4 * 4 + idx.numel() * 4 + idx.numel() * 4
    assert bounds.scale(1000, 2) == bounds.Work(4000, 1000)


@pytest.mark.parametrize("P,m", [(8, 4), (8, 2)])
def test_point_topm_reads_every_point_and_writes_the_kept(P, m):
    # the live dense layer: 5 views x 15,360 queries x 8 heads, 3 levels
    rows, Lt = 5 * 15360 * 8, 3
    work = bounds.point_topm(5, 15360, 8, Lt, P, m)
    weights_in, loc_in = rows * Lt * P * 4, rows * Lt * P * 2 * 4
    weights_out, loc_out = rows * Lt * m * 4, rows * Lt * m * 2 * 4
    assert work.bytes == weights_in + loc_in + weights_out + loc_out
    assert work.flops == 2 * rows * Lt * m
    assert work.bound_by == "bytes"
