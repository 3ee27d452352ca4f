"""The corner sampler's operands off the map, on the CPU.

`ops/sampling.py::corner_samples` turns locations into table rows of the
padded corner table of each level, (h + 2) * padded_width(w) rows. The
gather-reduce (`ops/table_gather.py`) gives a zero row for an index off the
table, where JAX's `_reference_reduce` gives NaN rows or wraps, so the two
agree only because no index leaves the table: every location, NaN, +-inf
and far off the map included, must give an index in [0, R). A finite
location whose stencil misses the map also gets corner weights of 0; a
non-finite one carries its NaN into the weights, in both packages.
"""

import math

import numpy as np
import pytest
import torch

from mvgformer_tpu_torch.ops import sampling, table_build, table_gather

SHAPES = ((16, 30), (8, 15), (4, 8))
OFF_MAP = {
    "nan_x": (math.nan, 0.5),
    "nan_y": (0.5, math.nan),
    "pos_inf": (math.inf, 0.5),
    "neg_inf": (0.5, -math.inf),
    "far_positive": (50.0, 50.0),
    "far_negative": (-50.0, -3.0),
    "huge": (1e20, -1e20),
    "just_outside": (-0.2, 1.2),
}


def _rows(h, w):
    return (h + 2) * table_build.padded_width(w)


def _locations(case, seed=0, N=2, Lq=6, H=3, P=4):
    """Uniform locations in [-0.2, 1.2] with the case's (x, y) put on every
    point of the first three queries."""
    rng = np.random.RandomState(seed)
    loc = rng.uniform(-0.2, 1.2, (N, Lq, H, len(SHAPES), P, 2))
    loc[:, :3] = OFF_MAP[case]
    aw = rng.rand(N, Lq, H, len(SHAPES), P)
    return (torch.from_numpy(loc.astype(np.float32)),
            torch.from_numpy(aw.astype(np.float32)))


@pytest.mark.parametrize("case", sorted(OFF_MAP))
def test_corner_samples_stay_on_the_table(case):
    loc, aw = _locations(case)
    N, Lq, H, L, P, _ = loc.shape
    for (h, w), (idx, w4) in zip(SHAPES, sampling.corner_samples(
            SHAPES, loc, aw, torch.float32)):
        assert idx.dtype == torch.int32 and idx.shape == (N * H, Lq * P)
        assert int(idx.min()) >= 0 and int(idx.max()) < _rows(h, w)
        if np.isfinite(OFF_MAP[case]).all():
            off = w4.reshape(N, H, Lq, P, 4)[:, :, :3]
            assert torch.equal(off, torch.zeros_like(off))
            assert torch.isfinite(w4).all()


@pytest.mark.parametrize("case", ["far_positive", "far_negative", "huge"])
def test_corner_sampler_reads_nothing_off_the_map(case):
    """Through the tables and the gather-reduce, the off-map queries give
    zero features and the others what deform_sample gives."""
    loc, aw = _locations(case, seed=1)
    N, Lq, H, L, P, _ = loc.shape
    gen = torch.Generator().manual_seed(1)
    value = torch.randn(N, sum(h * w for h, w in SHAPES), H, 8,
                        generator=gen)
    got = sampling.deform_sample_corner(value, SHAPES, loc, aw)
    want = sampling.deform_sample(value, SHAPES, loc, aw)
    assert torch.equal(got[:, :3], torch.zeros_like(got[:, :3]))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_gather_reduce_gives_zero_rows_off_the_table():
    """The documented difference from JAX: indices -1 and R read no row."""
    gen = torch.Generator().manual_seed(2)
    tables = torch.randn(2, 5, 4 * 3, generator=gen)
    idx = torch.tensor([[0, -1, 4, 5], [5, 2, -1, 1]], dtype=torch.int32)
    w4 = torch.rand(2, 4, 4, generator=gen)
    out = table_gather.deform_gather_reduce_plain(tables, idx, w4)
    off = (idx < 0) | (idx >= 5)
    assert torch.equal(out[off], torch.zeros_like(out[off]))
    assert torch.isfinite(out).all()
