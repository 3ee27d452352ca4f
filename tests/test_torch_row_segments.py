"""The sort of B3's backward wrapper (`table_gather.row_segments`) against
a numpy stable argsort per pair and `np.bincount`, on the CPU: indices all
on one row, all off the table but one row's, off the table on both sides,
uniform, and S = 0 and 1. Also the plain versions' rule for indices off the
table (no row read or written, grad_w4 0) against numpy, and the choice of
the backward kernel's instance. Exact: these are integer results, and the
plain versions' float32 sums over at most a few samples agree to 1e-6.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mvgformer_tpu_torch.ops import table_gather

KINDS = ("uniform", "one_row", "empty_but_one", "off_table")


def numpy_segments(idx: np.ndarray, R: int):
    """(keys, perm, offsets) by a stable argsort of each pair's rows and a
    bincount: the flat sorted keys p * (R + 1) + row, the flat sample at
    each sorted position, and where each (pair, row) starts."""
    NH, S = idx.shape
    row = np.where((idx >= 0) & (idx < R), idx, R)
    perm = np.concatenate([p * S + np.argsort(row[p], kind="stable")
                           for p in range(NH)]).astype(np.int64)
    counts = np.stack([np.bincount(row[p], minlength=R + 1)
                       for p in range(NH)])
    offsets = (np.cumsum(counts.reshape(-1)) - counts.reshape(-1)).reshape(
        NH, R + 1)
    keys = (np.arange(NH)[:, None] * (R + 1) + row).reshape(-1)[perm]
    return keys, perm, offsets


def make_idx(rng: np.random.Generator, kind: str, NH: int, R: int,
             S: int) -> np.ndarray:
    idx = rng.integers(0, R, (NH, S))
    if kind == "one_row":
        idx[:] = rng.integers(0, R)
    elif kind == "empty_but_one":
        idx = np.where(rng.random((NH, S)) < 0.5, rng.integers(0, R),
                       rng.choice([-1, R, R + 7], (NH, S)))
    elif kind == "off_table":
        idx = rng.integers(-3, R + 3, (NH, S))
    return idx.astype(np.int32)


def assert_segments(idx: np.ndarray, R: int):
    got = table_gather.row_segments(torch.from_numpy(idx), R)
    want = numpy_segments(idx, R)
    assert got.keys.dtype == torch.int32 and got.perm.dtype == torch.int64
    assert got.offsets.dtype == torch.int32
    assert tuple(got.offsets.shape) == (idx.shape[0], R + 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("kind", KINDS)
@settings(max_examples=40, deadline=None)
@given(NH=st.integers(1, 4), R=st.integers(1, 40), S=st.integers(0, 300),
       seed=st.integers(0, 2 ** 31 - 1))
def test_row_segments_match_numpy(kind, NH, R, S, seed):
    assert_segments(make_idx(np.random.default_rng(seed), kind, NH, R, S), R)


@pytest.mark.parametrize("S", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_row_segments_tiny(kind, S):
    assert_segments(make_idx(np.random.default_rng(S), kind, 3, 5, S), 5)


def test_row_segments_refuse_keys_past_int32():
    idx = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        table_gather.row_segments(idx, 2 ** 30)


@pytest.mark.parametrize("kind", ["off_table", "empty_but_one"])
def test_plain_versions_skip_indices_off_the_table(kind):
    rng = np.random.default_rng(3)
    NH, R, S, D = 2, 9, 60, 3
    idx = make_idx(rng, kind, NH, R, S)
    tables = rng.standard_normal((NH, R, 4 * D), dtype=np.float32)
    w4 = rng.standard_normal((NH, S, 4), dtype=np.float32)
    ct = rng.standard_normal((NH, S, D), dtype=np.float32)
    on = (idx >= 0) & (idx < R)
    rows = np.where(on[..., None], np.take_along_axis(
        tables, np.clip(idx, 0, R - 1)[..., None].astype(np.int64), 1), 0)
    rows = rows.reshape(NH, S, 4, D)
    want = (rows * w4[..., None]).sum(2)
    want_w = (rows * ct[:, :, None, :]).sum(-1)
    want_t = np.zeros_like(tables)
    for p in range(NH):
        for s in np.flatnonzero(on[p]):
            want_t[p, idx[p, s]] += (w4[p, s, :, None] * ct[p, s]).reshape(-1)
    t = [torch.from_numpy(a) for a in (tables, idx, w4, ct)]
    got = table_gather.gather_reduce_forward(*t[:3])
    got_t, got_w = table_gather.gather_reduce_backward(*t)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_w.numpy(), want_w, rtol=0, atol=1e-6)
    assert (got_w.numpy()[~on] == 0).all()


@pytest.mark.parametrize("D,dtype,want", [
    (8, torch.float32, 1), (16, torch.bfloat16, 2), (32, torch.bfloat16, 4),
    (32, torch.float32, 4), (64, torch.float32, 8), (40, torch.bfloat16, 0),
    (6, torch.float32, 0), (24, torch.bfloat16, 0)])
def test_backward_instance(D, dtype, want):
    tables = torch.zeros((2, 5, 4 * D), dtype=dtype)
    ct = torch.zeros((2, 7, D), dtype=dtype)
    assert table_gather.lane_elements(tables, ct) == want
    shifted = torch.zeros(2 * 7 * D + 1, dtype=dtype)[1:].view(2, 7, D)
    # a cotangent off 16-byte alignment takes the generic instance
    assert table_gather.lane_elements(tables, shifted) == 0
    # 16-byte vectors for the gathers where D * esize allows and aligned
    whole = (D * tables.element_size()) % 16 == 0
    assert table_gather.vector_bytes(tables, ct) == (
        16 if whole else tables.element_size())
    assert table_gather.vector_bytes(tables, shifted) == \
        tables.element_size()


@pytest.mark.parametrize("field,bad", [
    ("keys", lambda t: t[:-1]), ("perm", lambda t: t.int()),
    ("offsets", lambda t: t.t().contiguous().t()),
    ("offsets", lambda t: t.long())])
def test_backward_refuses_malformed_segments(field, bad):
    idx = torch.from_numpy(make_idx(np.random.default_rng(1), "uniform", 3,
                                    7, 20))
    good = table_gather.row_segments(idx, 7)
    table_gather._check_segments(good, 3, 7, 20, idx.device)
    wrong = good._replace(**{field: bad(getattr(good, field))})
    with pytest.raises(ValueError, match=f"segments.{field}"):
        table_gather._check_segments(wrong, 3, 7, 20, idx.device)
