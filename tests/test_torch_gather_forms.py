"""The plain versions of the probe kernels' ports (ops/gather_forms.py, on
the CPU) against the functions of the TPU sites in tools/probes/, on the
same numpy inputs, bit for bit in float32 and bfloat16:

  * P1, P2 (probe_pallas_gather.py: take, take_eq, one-hot) against that
    probe's xla_gather; P4, P5 (probe_pallas_gather2.py) against its
    xla_gather; P3 (trivial_kernel, 2 * tbl) against jnp;
  * P6's forms (probe_mosaic_gather_forms.py) against jnp.take,
    jnp.take_along_axis (axes 0 and 1) and lax.gather;
  * P7 (probe_onehot_parts.py) against B3's one-hot window kernel
    _onehot_select in interpret mode and against the jnp expression of the
    windowed select and copy; P8 (probe_sorted_gather_parts.py) against the
    jnp expression of its select over sorted rows, escapes clamped;
  * P9-P12 (probe_table_kernel_forms.py) against
    mvgformer_tpu.ops.sampling.build_corner_tables, and the slot maps d0-d4
    against form_d's store statements written in jnp; the slot codes the
    table slots hand B2's kernel (csrc/table_build.cu), and the table that
    kernel's index arithmetic makes of them, written out in numpy.

The TPU's one-hot forms (P2, P5) ran jnp.dot at default precision, which
rounds a float32 table to bfloat16 on the TPU; the contract here is the
exact row, as JAX computes the gather on the CPU. The probe scripts are
imported, never edited; probe_onehot_parts.py runs its timings at import,
so it is not imported and its expressions are written out here.
"""

import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvgformer_tpu.ops import onehot_gather as og
from mvgformer_tpu.ops import sampling as jsampling
from mvgformer_tpu_torch.ops import gather_forms, table_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = ["float32", "bfloat16"]


def _probe(name):
    path = os.path.join(REPO, "tools", "probes", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"tpu_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _pair(array, dtype):
    """The same numpy array as a jax array and a torch tensor of `dtype`."""
    return (jnp.asarray(array).astype(dtype),
            torch.from_numpy(np.ascontiguousarray(array)).to(
                getattr(torch, dtype)))


def _equal(got: torch.Tensor, want) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [64, 300])
def test_p1_p2_row_gather_equals_probe_xla_gather(rng, dtype, rows):
    probe = _probe("probe_pallas_gather")
    tbl = rng.randn(rows, 128).astype(np.float32)
    idx = rng.randint(0, rows, 512).astype(np.int32)
    jt, tt = _pair(tbl, dtype)
    want = probe.xla_gather(jnp.asarray(idx), jt)
    _equal(gather_forms.row_gather(tt, torch.from_numpy(idx)), want)
    # the take_eq form: take_along_axis with column-broadcast indices
    idx2d = np.broadcast_to(idx[:, None], (512, 128)).copy()
    _equal(gather_forms.take_along(tt, torch.from_numpy(idx2d), 0), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_p3_p4_p5_equal_probe2(rng, dtype):
    probe = _probe("probe_pallas_gather2")
    tbl = rng.randn(64, 128).astype(np.float32)
    idx = rng.randint(0, 64, 256).astype(np.int32)
    idx2d = np.broadcast_to(idx[:, None], (256, 128)).copy()
    jt, tt = _pair(tbl, dtype)
    want = probe.xla_gather(jnp.asarray(idx2d), jt)
    _equal(gather_forms.take_along(tt, torch.from_numpy(idx2d), 0), want)
    _equal(gather_forms.row_gather(tt, torch.from_numpy(idx2d[:, 0].copy())),
           want)
    _equal(gather_forms.scale(tt, 2.0), jt * 2.0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_p6_forms_equal_jnp(rng, dtype):
    tbl = rng.randn(96, 128).astype(np.float32)
    idx = rng.randint(0, 96, 64).astype(np.int32)
    jt, tt = _pair(tbl, dtype)
    ti = torch.from_numpy(idx)
    idx2d = np.broadcast_to(idx[:, None], (64, 128)).copy()
    # f1: take_along_axis axis 0 with (BLK, 128) indices
    _equal(gather_forms.take_along(tt, torch.from_numpy(idx2d), 0),
           jnp.take_along_axis(jt, jnp.asarray(idx2d), axis=0))
    # f2: jnp.take of rows; f6: eight dynamic row slices
    _equal(gather_forms.row_gather(tt, ti), jnp.take(jt, idx, axis=0))
    _equal(gather_forms.row_gather(tt, ti[:8].contiguous()),
           jnp.stack([jt[int(i)] for i in idx[:8]]))
    # f3: lax.gather with collapsed dim 0
    dn = jax.lax.GatherDimensionNumbers(offset_dims=(1,),
                                        collapsed_slice_dims=(0,),
                                        start_index_map=(0,))
    _equal(gather_forms.row_gather(tt, ti), jax.lax.gather(
        jt, jnp.asarray(idx)[:, None], dn, slice_sizes=(1, 128)))
    # f4: take_along_axis axis 0 on an (8, 128) table, per-element rows
    t8 = rng.randn(8, 128).astype(np.float32)
    i8 = rng.randint(0, 8, (8, 128)).astype(np.int32)
    j8, g8 = _pair(t8, dtype)
    _equal(gather_forms.take_along(g8, torch.from_numpy(i8), 0),
           jnp.take_along_axis(j8, jnp.asarray(i8), axis=0))
    # f5: take_along_axis axis 1 (lanes) on a (128, 128) table
    tl = rng.randn(128, 128).astype(np.float32)
    il = rng.randint(0, 128, (128, 128)).astype(np.int32)
    jl, gl = _pair(tl, dtype)
    _equal(gather_forms.take_along(gl, torch.from_numpy(il), 1),
           jnp.take_along_axis(jl, jnp.asarray(il), axis=1))


def _window_operands(rng, NH, R, nblk, BS, W):
    base8 = rng.randint(0, (R - W) // 8, (NH, nblk)).astype(np.int32)
    local = rng.randint(0, W, (NH, nblk * BS)).astype(np.int32)
    return base8, local


@pytest.mark.parametrize("dtype", DTYPES)
def test_p7_select_equals_onehot_kernel_interpret(rng, monkeypatch, dtype):
    """The production form of P7's select, B3's _onehot_select (a
    pallas_call), in interpret mode with its block and window made small."""
    monkeypatch.setenv("MVG_ONEHOT_INTERPRET", "1")
    monkeypatch.setattr(og, "BS", 64)
    monkeypatch.setattr(og, "W", 128)
    NH, R, C, nblk = 2, 400, 128, 3
    tables = rng.randn(NH, R, C).astype(np.float32)
    base8, local = _window_operands(rng, NH, R, nblk, 64, 128)
    jt, tt = _pair(tables, dtype)
    want = og._onehot_select(jt, jnp.asarray(base8),
                             jnp.asarray(local)[..., None])
    _equal(gather_forms.window_gather(tt, torch.from_numpy(base8),
                                      torch.from_numpy(local), 128), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_p7_variants_equal_jnp(rng, dtype):
    """probe_onehot_parts.py's variants: (DMA, matmul) = (on, on) is the
    select, (on, off) the window's first BS rows; the two with the DMA off
    have no defined output on the TPU and are zeros here."""
    NH, R, C, nblk, BS, W = 3, 500, 64, 4, 32, 64
    tables = rng.randn(NH, R, C).astype(np.float32)
    base8, local = _window_operands(rng, NH, R, nblk, BS, W)
    local[:, ::9] = W + 3  # off the window: the one-hot row is empty
    jt, tt = _pair(tables, dtype)
    tb, tl = torch.from_numpy(base8), torch.from_numpy(local)
    origin = 8 * jnp.repeat(jnp.asarray(base8), BS, axis=1)
    jl = jnp.asarray(local)
    rows = origin + jl
    select = jnp.where(((jl >= 0) & (jl < W))[..., None],
                       jnp.take_along_axis(jt, jnp.clip(rows, 0, R - 1)[
                           ..., None], axis=1), 0)
    _equal(gather_forms.window_gather(tt, tb, tl, W), select)
    copy_rows = origin + jnp.tile(jnp.arange(BS), nblk)[None]
    _equal(gather_forms.window_gather(tt, tb, tl, W, mode="copy"),
           jnp.take_along_axis(jt, copy_rows[..., None], axis=1))
    _equal(gather_forms.window_gather(tt, tb, tl, W, mode="zero"),
           jnp.zeros((NH, nblk * BS, C)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_p8_sorted_window_select_equals_jnp(rng, dtype):
    """probe_sorted_gather_parts.py's select: one pair, windows at floor8
    of each block's first sorted row capped at R - W, escapes clamped."""
    from mvgformer_tpu_torch.tools.probes import probe_sorted_gather_parts
    R, BS, W, S = 2000, 64, 32, 512
    table = rng.randn(R, 128).astype(np.float32)
    sorted_idx = np.sort(rng.randint(0, R, S)).astype(np.int32)
    base = np.minimum((sorted_idx.reshape(-1, BS)[:, 0] // 8) * 8, R - W)
    local = np.clip(sorted_idx.reshape(-1, BS) - base[:, None], 0, W - 1)
    jt, tt = _pair(table, dtype)
    want = jnp.take(jt, jnp.asarray((base[:, None] + local).reshape(-1)),
                    axis=0)
    tb, tl = probe_sorted_gather_parts.sorted_windows(
        torch.from_numpy(sorted_idx), BS, W, R)
    np.testing.assert_array_equal(tb.numpy(), base)
    np.testing.assert_array_equal(tl.numpy(), local.reshape(-1))
    got = gather_forms.window_gather(tt[None], tb[None], tl[None], W, 1)
    _equal(got[0], want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,w", [(16, 30), (5, 3), (1, 1)])
def test_p9_p12_table_equals_xla_build(rng, dtype, h, w):
    """B2's table (forms a, b, c, e) and the slot map d2: the first w + 2
    columns of every row are JAX's XLA build, the rest zero."""
    NH, D = 3, 8
    v = rng.randn(NH, h, w, D).astype(np.float32)
    jv, tv = _pair(v, dtype)
    ref = jsampling.build_corner_tables(jv.reshape(NH, h * w, 1, D),
                                        ((h, w),))[0]
    ref = np.asarray(ref.astype(jnp.float32)).reshape(NH, h + 2, w + 2,
                                                      4 * D)
    wpp = table_build.padded_width(w)
    for got in (table_build.build_corner_table(tv[:, None]),
                gather_forms.table_slots(tv, gather_forms.B2_SLOTS)):
        got = got.float().numpy().reshape(NH, h + 2, wpp, 4 * D)
        np.testing.assert_array_equal(got[:, :, :w + 2], ref)
        assert not got[:, :, w + 2:].any()


def _form_d_jnp(v, variant, wpp):
    """probe_table_kernel_forms.py::form_d's store statements (:174-201) on
    the whole padded level at once (one block of all h + 2 rows); the
    columns that d3 leaves unwritten are zero."""
    NH, h, w, D = v.shape
    hp = h + 2
    vp = jnp.pad(v, ((0, 0), (1, 2), (0, 0), (0, 0)))
    cur, nxt = vp[:, 0:hp], vp[:, 1:hp + 1]
    out = jnp.zeros((NH, hp, wpp, 4 * D), v.dtype)
    if variant == 0:
        out = out.at[:, :, 0:w, 0:D].set(cur)
    elif variant in (1, 3):
        out = out.at[:, :, 0:w, :].set(
            jnp.concatenate([cur, cur, nxt, nxt], axis=-1))
    elif variant == 2:
        out = out.at[:, :, 1:w + 1, 0:D].set(cur)
        out = out.at[:, :, 0:w, D:2 * D].set(cur)
        out = out.at[:, :, 1:w + 1, 2 * D:3 * D].set(nxt)
        out = out.at[:, :, 0:w, 3 * D:4 * D].set(nxt)
    else:
        c00 = jnp.pad(cur, ((0, 0), (0, 0), (1, wpp - w - 1), (0, 0)))
        out = jnp.concatenate([c00] * 4, axis=-1)
    return out.reshape(NH, hp * wpp, 4 * D)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", range(5))
def test_p11_slot_maps_equal_form_d(rng, dtype, variant):
    NH, h, w, D = 2, 16, 30, 8
    v = rng.randn(NH, h, w, D).astype(np.float32)
    jv, tv = _pair(v, dtype)
    want = _form_d_jnp(jv, variant, table_build.padded_width(w))
    _equal(gather_forms.table_slots(tv, gather_forms.SLOT_MAPS[
        f"d{variant}"]), want)


SLOT_CODES = {"d0": (0, -1, -1, -1), "d1": (0, 0, 2, 2), "d2": (1, 0, 3, 2),
              "d3": (0, 0, 2, 2), "d4": (1, 1, 1, 1)}


def _kernel_index_map(v, codes, b2):
    """The table csrc/table_build.cu writes, indexed as its threads index
    it: slot c of row (y, x) reads v[y - 1 + code // 2, x - code % 2] for
    the slot's code (B2's compile-time instance: (c & 2) | (1 - (c & 1))),
    zero off the map and for the code -1."""
    NH, h, w, D = v.shape
    wpp = table_build.padded_width(w)
    out = np.zeros((NH, h + 2, wpp, 4, D), v.dtype)
    for c in range(4):
        code = (c & 2) | (1 - (c & 1)) if b2 else codes[c]
        if code < 0:
            continue
        for y in range(h + 2):
            for x in range(wpp):
                sy, sx = y - 1 + (code >> 1), x - (code & 1)
                if 0 <= sy < h and 0 <= sx < w:
                    out[:, y, x, c] = v[:, sy, sx]
    return out.reshape(NH, (h + 2) * wpp, 4 * D)


def _b2_instance_codes():
    """The codes for which csrc/table_build.cu runs B2's instance."""
    src = table_build._SRC.read_text()
    found = re.search(r"b2 = s0 == (-?\d) && s1 == (-?\d) && "
                      r"s2 == (-?\d) && s3 == (-?\d);", src)
    return tuple(int(g) for g in found.groups())


@pytest.mark.parametrize("name", sorted(SLOT_CODES))
def test_slot_codes_index_the_plain_table(rng, name):
    """Each of d0-d4 gives its codes, and the table the kernel's index
    arithmetic makes of them is the plain version's; only B2_SLOTS gives
    B2_CODES, the codes of B2's own instance, whose fixed map makes the
    same table as B2's plain build."""
    slots = gather_forms.SLOT_MAPS[name]
    codes = gather_forms.slot_codes(slots)
    assert codes == SLOT_CODES[name]
    v = rng.randn(2, 3, 5, 2).astype(np.float32)
    want = gather_forms.table_slots_plain(torch.from_numpy(v), slots).numpy()
    np.testing.assert_array_equal(_kernel_index_map(v, codes, b2=False),
                                  want)
    assert _b2_instance_codes() == table_build.B2_CODES
    assert (codes == table_build.B2_CODES) == (slots ==
                                               gather_forms.B2_SLOTS)
    if slots == gather_forms.B2_SLOTS:
        np.testing.assert_array_equal(_kernel_index_map(v, codes, b2=True),
                                      want)
        np.testing.assert_array_equal(
            table_build.build_corner_table_plain(
                torch.from_numpy(v)[:, None]).numpy(), want)


def test_table_slots_hand_their_codes_to_b2_kernel(monkeypatch):
    """On a card the wrapper launches B2's kernel on the (NH, 1, h, w, D)
    view with the map's codes, counting its own launches and not B2's."""
    seen = []
    monkeypatch.setattr(gather_forms, "_check_device", lambda *t: "cuda")
    monkeypatch.setattr(table_build, "launch_table", lambda v, codes: (
        seen.append((tuple(v.shape), tuple(codes))), v)[1])
    monkeypatch.setattr(gather_forms.table_slots, "launches", 0)
    b2_before = table_build.build_corner_table.launches
    v = torch.zeros(4, 3, 5, 2)
    for slots in gather_forms.SLOT_MAPS.values():
        gather_forms.table_slots(v, slots)
    assert seen == [((4, 1, 3, 5, 2), SLOT_CODES[name])
                    for name in gather_forms.SLOT_MAPS]
    assert gather_forms.table_slots.launches == len(SLOT_CODES)
    assert table_build.build_corner_table.launches == b2_before


def test_plain_versions_zero_what_lies_off_the_table():
    tbl = torch.arange(12.0).reshape(1, 4, 3)
    idx = torch.tensor([[0, -1, 4, 3]], dtype=torch.int32)
    got = gather_forms.row_gather(tbl, idx)
    assert torch.equal(got[0, 0], tbl[0, 0]) and torch.equal(got[0, 3],
                                                             tbl[0, 3])
    assert not got[0, 1:3].any()
    t2 = torch.arange(6.0).reshape(2, 3)
    got = gather_forms.take_along(t2, torch.tensor([[0, 5, -1]],
                                                   dtype=torch.int32), 0)
    assert got.tolist() == [[0.0, 0.0, 0.0]]
    got = gather_forms.take_along(t2, torch.tensor([[2, 3], [-1, 1]],
                                                   dtype=torch.int32), 1)
    assert got.tolist() == [[2.0, 0.0], [0.0, 4.0]]


def test_wrappers_check_their_arguments():
    tbl = torch.zeros(2, 10, 4)
    base = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="BS"):
        gather_forms.window_gather(tbl, base, torch.zeros(
            2, 12, dtype=torch.int32), W=3, mode="copy")
    with pytest.raises(ValueError, match="nblk"):
        gather_forms.window_gather(tbl, base, torch.zeros(
            2, 10, dtype=torch.int32), W=8)
    with pytest.raises(ValueError, match="mode"):
        gather_forms.window_gather(tbl, base, torch.zeros(
            2, 12, dtype=torch.int32), W=8, mode="dma")
    with pytest.raises(ValueError):
        gather_forms.take_along(torch.zeros(4, 3), torch.zeros(
            2, 5, dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        gather_forms.table_slots(torch.zeros(1, 2, 2, 4), ((0, 2),) * 4)
    with pytest.raises(ValueError, match="device"):
        gather_forms.row_gather(tbl, torch.zeros(2, 3, dtype=torch.int32,
                                                 device="meta"))


def test_plain_versions_launch_nothing(rng):
    before = [k.launches for k in gather_forms.KERNELS]
    tbl = torch.from_numpy(rng.randn(2, 40, 8).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 40, (2, 16)).astype(np.int32))
    gather_forms.row_gather(tbl, idx)
    gather_forms.window_gather(tbl, torch.zeros(2, 2, dtype=torch.int32),
                               idx, W=16, unit=1)
    gather_forms.take_along(tbl[0], idx[:, :8].reshape(2, 8), 0)
    gather_forms.scale(tbl, 3.0)
    gather_forms.table_slots(tbl.reshape(2, 5, 8, 8)[..., :4].contiguous())
    assert [k.launches for k in gather_forms.KERNELS] == before
