"""The serving Jacobi DLT kernel (`ops/dlt_jacobi.py`, `csrc/dlt_jacobi.cu`)
against the decoder layer's plain chain (`dlt_jacobi.plain_dlt`), on the
card:

  * batch 1 and 8 at 960 points and 5 views, and 3 and 10 views, on a ring
    of distorted Panoptic-like cameras, points inside the capture space
    seen through noisy 2D detections: within 0.05 mm or 1e-5 relative;
    strided points and logits (the layer's own layouts at batch 8) give
    the bits of contiguous ones;
  * masked-out queries are zeros; an all-zero system (a view set whose
    projections vanish) gives the origin exactly; a near-degenerate Gram
    matrix (three cameras a micrometre apart) gives finite points; ties
    in the eigenvalues take the first index, as torch.argmin;
  * the refusals: dtype, shape, device, more than 10 views, a
    non-contiguous per-view input, an input that requires grad;
  * a toy DQ model served on the card launches the kernel once per layer,
    its first layer within the tolerance above of the plain chain's, and a
    toy training step launches none and counts its plain calls.

This file imports neither jax nor the `rng` fixture of conftest.py, so it
also runs on a machine without JAX:

    python -m pytest tests/test_torch_dlt_kernel.py -m gpu --noconftest
"""

import pytest
import torch

from mvgformer_tpu_torch.config import load_config
from mvgformer_tpu_torch.data.synthetic import make_batch
from mvgformer_tpu_torch.geometry.cameras import (CameraParams,
                                                  projection_matrices)
from mvgformer_tpu_torch.ops import dlt_jacobi
from mvgformer_tpu_torch.ops.dlt_jacobi import fused_dlt, plain_dlt
from mvgformer_tpu_torch.tools.launch_cost import (DLT_SPACE_CENTER,
                                                   dlt_inputs, dlt_rig)

SPACE_CENTER = DLT_SPACE_CENTER
SPACE_SIZE = (8000.0, 8000.0, 2000.0)
ATOL_MM, RTOL = 0.05, 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain chain's
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = matmul


def operands(B, N, V, seed=0, noise_px=2.0, masked=0.3):
    return dlt_inputs(B, N, V, seed, noise_px, masked, device="cpu")


def to(ops, device):
    out = {k: v.to(device) for k, v in ops.items() if k != "cameras"}
    out["cameras"] = ops["cameras"].to(device)
    return out


def run_both(ops):
    """The kernel's and the plain chain's points, on the card; the kernel
    launched once."""
    before = fused_dlt.launches
    got = fused_dlt(**ops)
    want = plain_dlt(**ops)
    torch.cuda.synchronize()
    assert fused_dlt.launches == before + 1
    return got.cpu(), want.cpu()


def inside(points):
    c = torch.tensor(SPACE_CENTER)
    half = torch.tensor(SPACE_SIZE) / 2
    return ((points - c).abs() <= half).all(dim=-1)


def assert_close_inside(got, want, mask):
    assert got.shape == want.shape
    assert torch.equal(got[~mask], torch.zeros_like(got[~mask]))
    keep = mask & inside(want)
    # the operands put nearly every point inside the space
    assert keep.sum() >= 0.95 * mask.sum(), (keep.sum(), mask.sum())
    err = (got - want).abs()[keep]
    bound = ATOL_MM + RTOL * want.abs()[keep]
    assert (err <= bound).all(), (err.max(), (err - bound).max())
    assert torch.isfinite(got[mask]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,V", [(1, 960, 5), (8, 960, 5), (1, 960, 3),
                                   (1, 960, 10), (3, 77, 4)])
def test_fused_dlt_matches_plain_chain(cuda, B, N, V):
    ops = operands(B, N, V, seed=B * 100 + V)
    got, want = run_both(to(ops, cuda))
    assert_close_inside(got, want, ops["mask"])


@pytest.mark.gpu
def test_fused_dlt_takes_the_layers_strided_operands(cuda):
    """At batch 8 the layer's refined points are (V, B, N, 2) over a
    (B, V, N, 2) buffer and its logits a slice of the offset head's
    (V, B, N, 3) output: the kernel reads them at their strides, for the
    same bits as contiguous copies."""
    B, N, V = 8, 960, 5
    ops = to(operands(B, N, V, seed=5), cuda)
    want = fused_dlt(**ops)
    head = torch.randn(V, B, N, 3, device=cuda)
    head[..., 2] = ops["logits"]
    strided = dict(ops, refined=ops["refined"].transpose(0, 1).contiguous()
                   .transpose(0, 1), logits=head[..., 2])
    assert not strided["refined"].is_contiguous()
    assert not strided["logits"].is_contiguous()
    assert torch.equal(fused_dlt(**strided), want)


@pytest.mark.gpu
def test_fused_dlt_masked_out_queries_are_zero(cuda):
    ops = operands(2, 200, 5, seed=11, masked=1.0)
    assert not ops["mask"].any()
    got, want = run_both(to(ops, cuda))
    assert torch.equal(got, torch.zeros_like(got))
    assert torch.equal(want, torch.zeros_like(want))


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [0.0, 1e-13])
def test_fused_dlt_all_zero_system_gives_the_origin(cuda, scale):
    """A view set whose projections vanish (or fall under the guard's
    1e-10) has an all-zero system: the origin, exactly, as the plain
    chain's substituted rows solve to."""
    ops = operands(2, 64, 5, seed=13, masked=0.0)
    ops["proj"] = ops["proj"].clone()
    ops["proj"][1] = ops["proj"][1] / ops["proj"][1].abs().amax() * scale
    got, want = run_both(to(ops, cuda))
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    assert torch.equal(want[1], torch.zeros_like(want[1]))
    assert_close_inside(got[:1], want[:1], ops["mask"][:1])


@pytest.mark.gpu
def test_fused_dlt_near_degenerate_gram_is_finite(cuda):
    """Three cameras a micrometre apart see nearly the same ray: the Gram
    matrix has a second eigenvalue near zero. Both paths stay finite."""
    B, N, V = 1, 256, 3
    ops = operands(B, N, V, seed=17, noise_px=0.0, masked=0.0)
    vd, _ = dlt_rig(B, V, 17)
    cams = vd.cameras
    fields = {}
    for name in ("R", "T", "f", "c", "k", "p"):
        t = getattr(cams, name)
        fields[name] = t[:, :1].expand(t.shape).contiguous()
    fields["T"] = fields["T"] + torch.tensor(
        [0.0, 1e-3, 2e-3]).reshape(1, V, 1, 1)
    near = CameraParams(**fields)
    inv_affine = vd.inv_affine[:, :1].expand(vd.inv_affine.shape)
    ops.update(cameras=near, inv_affine=inv_affine.contiguous(),
               proj=projection_matrices(near, inv_trans=True))
    ops["refined"] = ops["refined"][:1].expand(ops["refined"].shape) \
        .contiguous()
    got, want = run_both(to(ops, cuda))
    assert torch.isfinite(got).all()
    assert torch.isfinite(want).all()


@pytest.mark.gpu
def test_fused_dlt_eigenvalue_ties_take_the_first_index(cuda):
    """Two views whose third projection rows vanish and whose first two
    rows are e0, e1 and e2, e3: with equal weights the equilibrated Gram
    matrix is the identity, four tied eigenvalues. torch.argmin takes the
    first, e0, which dehomogenises to (inf, nan, nan); the last would give
    the origin."""
    B, N, V = 1, 32, 2
    ops = operands(B, N, V, seed=19, masked=0.0)
    proj = torch.zeros(B, V, 3, 4)
    proj[0, 0, 0, 0] = proj[0, 0, 1, 1] = 1.0
    proj[0, 1, 0, 2] = proj[0, 1, 1, 3] = 1.0
    ops.update(proj=proj, logits=torch.zeros(V, B, N))
    got, want = run_both(to(ops, cuda))
    assert torch.isinf(got[..., 0]).all()
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got[~got.isnan()], want[~want.isnan()])


@pytest.mark.gpu
def test_fused_dlt_refuses_what_it_does_not_take(cuda):
    ops = to(operands(1, 16, 3, seed=23), cuda)
    with pytest.raises(TypeError, match="float32"):
        fused_dlt(**dict(ops, refined=ops["refined"].double()))
    with pytest.raises(TypeError, match="bool"):
        fused_dlt(**dict(ops, mask=ops["mask"].float()))
    with pytest.raises(ValueError, match="logits must be"):
        fused_dlt(**dict(ops, logits=ops["logits"][:, :, :8]))
    with pytest.raises(ValueError, match="several devices"):
        fused_dlt(**dict(ops, mask=ops["mask"].cpu()))
    with pytest.raises(ValueError, match="contiguous"):
        proj = ops["proj"].transpose(2, 3).contiguous().transpose(2, 3)
        fused_dlt(**dict(ops, proj=proj))
    with pytest.raises(NotImplementedError, match="backward"):
        fused_dlt(**dict(ops, refined=ops["refined"].requires_grad_()))
    many = to(operands(1, 16, 11, seed=29), cuda)
    with pytest.raises(ValueError, match="at most 10"):
        fused_dlt(**many)


def toy_cfg():
    cfg = load_config()
    cfg.NETWORK.IMAGE_SIZE = [96, 64]
    cfg.DECODER.d_model = 32
    cfg.DECODER.dim_feedforward = 64
    cfg.DECODER.nhead = 4
    cfg.DECODER.dec_n_points = 4
    cfg.DECODER.num_decoder_layers = 2
    cfg.DECODER.num_instance = 16
    cfg.DECODER.inference_topk_queries = 8
    cfg.DECODER.triangulation_method = "jacobi"
    cfg.POSE_RESNET.NUM_LAYERS = 18
    cfg.POSE_RESNET.NUM_DECONV_FILTERS = [32, 32, 32]
    cfg.DATASET.CAMERA_NUM = 5
    cfg.MULTI_PERSON.MAX_PEOPLE_NUM = 4
    cfg.PARALLEL.COMPUTE_DTYPE = "float32"
    return cfg


@pytest.mark.gpu
def test_served_model_launches_the_kernel_per_layer(cuda, monkeypatch):
    from mvgformer_tpu_torch.models import build_model

    cfg = toy_cfg()
    model = build_model(cfg, generator=torch.Generator().manual_seed(0),
                        device=cuda).eval()
    batch = make_batch(cfg, batch_size=2, seed=3, device=cuda)
    launches, plain = fused_dlt.launches, fused_dlt.plain_calls
    with torch.inference_mode():
        fused = model(batch, threshold=0.0)
    torch.cuda.synchronize()
    layers = cfg.DECODER.num_decoder_layers
    assert fused_dlt.launches - launches == layers
    assert fused_dlt.plain_calls == plain
    monkeypatch.setattr(dlt_jacobi, "fused_path", lambda *a: False)
    with torch.inference_mode():
        ref = model(batch, threshold=0.0)
    assert fused_dlt.launches - launches == layers
    got, want = fused[0]["pred_poses"].cpu(), ref[0]["pred_poses"].cpu()
    err = (got - want).abs()
    assert (err <= ATOL_MM + RTOL * want.abs()).all(), err.max()
    for a, b in zip(fused, ref):
        assert torch.allclose(a["pred_logits"], b["pred_logits"],
                              atol=1e-4)


@pytest.mark.gpu
def test_training_step_keeps_the_plain_chain(cuda):
    from mvgformer_tpu_torch.core.train import (create_train_state,
                                                make_train_step)
    from mvgformer_tpu_torch.models import build_model

    cfg = toy_cfg()
    cfg.DECODER.inference_topk_queries = None
    model = build_model(cfg, generator=torch.Generator().manual_seed(0),
                        device=cuda)
    state, tx = create_train_state(cfg, model)
    step = make_train_step(cfg, model, tx)
    batch = make_batch(cfg, batch_size=1, seed=5, device=cuda)
    launches, plain = fused_dlt.launches, fused_dlt.plain_calls
    state, losses = step(state, batch, torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    assert fused_dlt.launches == launches
    assert fused_dlt.plain_calls - plain >= cfg.DECODER.num_decoder_layers
