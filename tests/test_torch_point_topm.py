"""Point-top-m in ProjAttn (`ops/point_topm.py`, `csrc/point_topm.cu`).

On the CPU: the wrapper's plain path against `top_indices` and the chain
ProjAttn ran before the wrapper, for P 4 and 8 and every m in [1, P), on
distinct weights and three tie patterns (every weight equal, equal pairs
in each row, rows equal across the levels): the kept indices in the same
order, and the same weights and locations, bit for bit; and the kernel's
rule (rank counting, the kept sum in slot order) written out in Python
against the plain path.

On the card (marker `gpu`): the kernel against the plain path at the live
dense layer's shape (5, 15360, 8, 3, 8) and a top-64 layer's (5, 960, 8, 3,
8), m 4 and 2, and the tie patterns: the kept order and locations equal,
the weights within rtol 1e-6 (the kept sum is added in another order than
torch.sum's); no synchronization; the counter one up a call; the refusals;
a served toy model launches the kernel once per decoder layer, a training
step never.

This file imports neither jax nor the fixtures of conftest.py, so the card
tests also run on a machine without JAX:

    python -m pytest tests/test_torch_point_topm.py -m gpu --noconftest
"""

import pytest
import torch

from mvgformer_tpu_torch.ops import point_topm as pt
from mvgformer_tpu_torch.ops.projattn import top_indices
from mvgformer_tpu_torch.utils import profiling

PATTERNS = ("distinct", "all_equal", "pairs_equal", "equal_across_levels")
CASES = [(P, m) for P in (4, 8) for m in range(1, P)]
WEIGHTS_RTOL = 1e-6


def logits(shape, pattern, seed=0, device="cpu"):
    """(N, Lq, H, Lt, P) attention logits of a tie pattern."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen)
    if pattern == "all_equal":
        x = torch.zeros(shape)
    elif pattern == "pairs_equal":
        x = x[..., ::2].repeat_interleave(2, dim=-1)[..., :shape[-1]]
    elif pattern == "equal_across_levels":
        x = x[..., :1, :].expand(shape).contiguous()
    return x.to(device)


def operands(shape, pattern, seed=0, device="cpu"):
    """Softmaxed weights over (Lt, P), as ProjAttn makes them, and
    locations whose x is each point's index (so the kept locations show
    the kept order) and whose y is noise."""
    N, Lq, H, Lt, P = shape
    w = torch.softmax(logits(shape, pattern, seed, device)
                      .reshape(N, Lq, H, Lt * P), dim=-1).reshape(shape)
    gen = torch.Generator().manual_seed(seed + 1)
    loc = torch.stack([torch.arange(P, dtype=torch.float32).expand(shape),
                       torch.rand(shape, generator=gen)], dim=-1)
    return w, loc.to(device)


def old_chain(weights, locations, m):
    """ProjAttn's point-top-m as it was written inline, on `top_indices`."""
    idx = top_indices(weights, m)
    w_sel = torch.gather(weights, -1, idx)
    kept = w_sel.sum(dim=(-2, -1), keepdim=True)
    w_sel = w_sel / torch.clamp(kept, min=1e-6)
    loc_sel = torch.gather(locations, 4,
                           idx[..., None].expand(idx.shape + (2,)))
    return idx, w_sel, loc_sel


def rank_select(weights, locations, m):
    """The kernel's rule in Python: rank_i = #{j: w_j > w_i} + #{j < i:
    w_j == w_i}, point i kept at slot rank_i where rank_i < m, the kept
    sum over (level, slot) in double."""
    P = weights.shape[-1]
    wi, wj = weights[..., :, None], weights[..., None, :]
    lower = torch.arange(P)[None, :] < torch.arange(P)[:, None]
    rank = ((wj > wi) | ((wj == wi) & lower)).sum(-1)
    slot = (rank[..., None] == torch.arange(m)).to(weights.dtype)
    w_sel = torch.einsum("...ps,...p->...s", slot, weights)
    loc_sel = torch.einsum("...ps,...pc->...sc", slot, locations)
    kept = w_sel.double().sum(dim=(-2, -1), keepdim=True).float()
    return w_sel / torch.clamp(kept, min=1e-6), loc_sel


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("P,m", CASES)
def test_plain_path_is_the_old_chain(P, m, pattern):
    w, loc = operands((2, 5, 3, 3, P), pattern, seed=P * 10 + m)
    idx, want_w, want_loc = old_chain(w, loc, m)
    got_w, got_loc = pt.point_topm(w, loc, m)
    assert got_w.shape == (2, 5, 3, 3, m)
    assert got_loc.shape == (2, 5, 3, 3, m, 2)
    # the kept order: each kept location's x is its point's index
    assert torch.equal(got_loc[..., 0].long(), idx)
    assert torch.equal(got_w, want_w)
    assert torch.equal(got_loc, want_loc)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("P,m", [(8, 4), (8, 2), (4, 1)])
def test_rank_counting_is_the_stable_sort(P, m, pattern):
    w, loc = operands((2, 7, 3, 3, P), pattern, seed=P + m)
    want_w, want_loc = pt.plain_point_topm(w, loc, m)
    got_w, got_loc = rank_select(w, loc, m)
    assert torch.equal(got_loc, want_loc)
    torch.testing.assert_close(got_w, want_w, rtol=WEIGHTS_RTOL, atol=0)


def test_ties_keep_the_lowest_indices_in_order():
    w = torch.full((1, 1, 1, 3, 8), 1.0 / 24)
    w[..., 1, 6] = 0.5
    _, loc = operands(tuple(w.shape), "distinct")
    got_w, got_loc = pt.point_topm(w, loc, 4)
    assert got_loc[0, 0, 0, :, :, 0].tolist() == [
        [0, 1, 2, 3], [6, 0, 1, 2], [0, 1, 2, 3]]
    kept = 11 / 24 + 0.5
    torch.testing.assert_close(got_w[0, 0, 0, 1, 0], torch.tensor(0.5 / kept))


def test_plain_path_refuses_bad_shapes():
    w, loc = operands((1, 2, 1, 3, 4), "distinct")
    with pytest.raises(ValueError, match="weights must be"):
        pt.point_topm(w[0], loc[0], 2)
    with pytest.raises(ValueError, match="locations must be"):
        pt.point_topm(w, loc[..., 0], 2)
    for m in (0, 4):
        with pytest.raises(ValueError, match="m must lie"):
            pt.point_topm(w, loc, m)
    with pytest.raises(ValueError, match="unsupported device"):
        pt.point_topm(w.to("meta"), loc.to("meta"), 2)


def test_plain_path_counts_no_launch():
    before = profiling.COUNTERS[pt.COUNTER]
    pt.point_topm(*operands((1, 2, 1, 3, 8), "distinct"), 4)
    assert profiling.COUNTERS[pt.COUNTER] == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

DENSE, TOP64 = (5, 15360, 8, 3, 8), (5, 960, 8, 3, 8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def kernel_and_plain(w, loc, m):
    """The kernel's and the plain path's outputs on the card, the kernel's
    synchronizations, and the counter's move over the kernel's call."""
    before = profiling.COUNTERS[pt.COUNTER]
    with torch.inference_mode():
        (got_w, got_loc), syncs = profiling.count_syncs(pt.point_topm, w,
                                                        loc, m)
        launches = profiling.COUNTERS[pt.COUNTER] - before
        want_w, want_loc = pt.plain_point_topm(w, loc, m)
    torch.cuda.synchronize()
    return (got_w, got_loc), (want_w, want_loc), syncs, launches


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("m", [4, 2])
@pytest.mark.parametrize("shape", [DENSE, TOP64], ids=["dense", "top64"])
def test_kernel_matches_the_plain_path(cuda, shape, m, pattern):
    w, loc = operands(shape, pattern, seed=m, device=cuda)
    # the x coordinate as ProjAttn's: a [0, 1] position, index-tagged
    loc[..., 0] = loc[..., 0] / 8 + torch.rand(shape, device=cuda) / 16
    (got_w, got_loc), (want_w, want_loc), syncs, launches = \
        kernel_and_plain(w, loc, m)
    assert syncs == 0
    assert launches == 1
    assert torch.equal(got_loc, want_loc)
    torch.testing.assert_close(got_w, want_w, rtol=WEIGHTS_RTOL, atol=0)


@pytest.mark.gpu
def test_kernel_on_zero_rows_launches_nothing(cuda):
    w, loc = operands((5, 0, 8, 3, 8), "distinct", device=cuda)
    before = profiling.COUNTERS[pt.COUNTER]
    got_w, got_loc = pt.point_topm(w, loc, 4)
    assert got_w.shape == (5, 0, 8, 3, 4) and got_loc.shape[-2:] == (4, 2)
    assert profiling.COUNTERS[pt.COUNTER] == before


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    w, loc = operands((2, 16, 8, 3, 8), "distinct", device=cuda)
    with pytest.raises(ValueError, match="no kernel instance"):
        pt.point_topm(w, loc, 3)
    w4, loc4 = operands((2, 16, 8, 3, 4), "distinct", device=cuda)
    with pytest.raises(ValueError, match="no kernel instance"):
        pt.point_topm(w4, loc4, 2)
    with pytest.raises(TypeError, match="float32"):
        pt.point_topm(w.bfloat16(), loc, 4)
    strided = torch.empty((2, 16, 8, 3, 16), device=cuda)[..., ::2]
    strided.copy_(w)
    with pytest.raises(ValueError, match="contiguous"):
        pt.point_topm(strided, loc, 4)
    with pytest.raises(ValueError, match="contiguous"):
        pt.point_topm(w, loc.transpose(0, 1).contiguous().transpose(0, 1),
                      4)
    with pytest.raises(ValueError, match="several devices"):
        pt.point_topm(w, loc.cpu(), 4)
    with pytest.raises(NotImplementedError, match="no backward"):
        pt.point_topm(w.requires_grad_(), loc, 4)


def toy_cfg():
    from mvgformer_tpu_torch.config import load_config

    cfg = load_config()
    cfg.NETWORK.IMAGE_SIZE = [96, 64]
    cfg.DECODER.d_model = 32
    cfg.DECODER.dim_feedforward = 64
    cfg.DECODER.nhead = 4
    cfg.DECODER.dec_n_points = 8
    cfg.DECODER.num_decoder_layers = 2
    cfg.DECODER.num_instance = 16
    cfg.DECODER.inference_topk_queries = 8
    cfg.DECODER.inference_point_topm = 4
    cfg.DECODER.triangulation_method = "jacobi"
    cfg.POSE_RESNET.NUM_LAYERS = 18
    cfg.POSE_RESNET.NUM_DECONV_FILTERS = [32, 32, 32]
    cfg.DATASET.CAMERA_NUM = 5
    cfg.MULTI_PERSON.MAX_PEOPLE_NUM = 4
    cfg.PARALLEL.COMPUTE_DTYPE = "float32"
    return cfg


@pytest.mark.gpu
def test_served_model_launches_the_kernel_per_layer(cuda, monkeypatch):
    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.models import build_model
    from mvgformer_tpu_torch.ops import projattn

    cfg = toy_cfg()
    model = build_model(cfg, generator=torch.Generator().manual_seed(0),
                        device=cuda).eval()
    batch = make_batch(cfg, batch_size=2, seed=3, device=cuda)
    before = profiling.COUNTERS[pt.COUNTER]
    with torch.inference_mode():
        fused = model(batch, threshold=0.0)
    torch.cuda.synchronize()
    layers = cfg.DECODER.num_decoder_layers
    assert profiling.COUNTERS[pt.COUNTER] - before == layers
    monkeypatch.setattr(projattn, "select_point_topm", pt.plain_point_topm)
    with torch.inference_mode():
        ref = model(batch, threshold=0.0)
    assert profiling.COUNTERS[pt.COUNTER] - before == layers
    for a, b in zip(fused, ref):
        for key in ("pred_logits", "pred_poses"):
            torch.testing.assert_close(a[key], b[key], rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_training_step_never_launches_the_kernel(cuda):
    from mvgformer_tpu_torch.core.train import (create_train_state,
                                                make_train_step)
    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.models import build_model

    cfg = toy_cfg()
    model = build_model(cfg, generator=torch.Generator().manual_seed(0),
                        device=cuda)
    state, tx = create_train_state(cfg, model)
    step = make_train_step(cfg, model, tx)
    batch = make_batch(cfg, batch_size=1, seed=5, device=cuda)
    before = profiling.COUNTERS[pt.COUNTER]
    step(state, batch, torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    assert profiling.COUNTERS[pt.COUNTER] == before
