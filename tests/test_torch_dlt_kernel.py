"""The Jacobi DLT kernels (`ops/dlt_jacobi.py`, `csrc/dlt_jacobi.cu`)
against the decoder layer's plain chain (`dlt_jacobi.plain_dlt`).

On the CPU: the backward kernel's rule written out in Python
(`kernel_backward`, per point in the kernel's order) against
torch.autograd through `plain_dlt`, and through `image_points` +
`solve_views` with the clip, in float64 (the chain's float32 casts lifted
for the comparison, so that what is compared is the rule and not float32's
rounding): random systems at V 3, 5 and 10; a near-degenerate Gram matrix;
tied eigenvalues (the first index, as torch.argmin); a rotation at tau ==
0; the all-zero system (the origin: no cotangent); masked-out points
(exact zeros); the clip.

On the card (marker `gpu`):

  * the forward at batch 1 and 8 at 960 points and 5 views, and 3 and 10
    views, on a ring of distorted Panoptic-like cameras, points inside the
    capture space seen through noisy 2D detections: within 0.05 mm or
    1e-5 relative; strided points and logits (the layer's own layouts at
    batch 8) give the bits of contiguous ones;
  * masked-out queries are zeros; an all-zero system (a view set whose
    projections vanish) gives the origin exactly; a near-degenerate Gram
    matrix (three cameras a micrometre apart) gives finite points; ties
    in the eigenvalues take the first index, as torch.argmin;
  * the refusals: dtype, shape, device, more than 10 views, a
    non-contiguous per-view input, a camera, crop or projection input
    that requires grad;
  * the backward kernel against autograd through the plain chain at the
    training layer's shape (1, 15360, 5), at V 3 and B 2, and at V 10,
    each held to the float64 gradient as closely as the chain's own
    float32 autograd is; finite on a near-degenerate Gram matrix; exact
    zeros at masked-out points; the clip against `solve_views`'; forward
    and backward make no synchronization;
  * a toy DQ model served on the card launches the kernel once per layer,
    its first layer within the tolerance above of the plain chain's; a
    toy training step under remat launches the forward twice and the
    backward once a layer and no plain call, and gives the plain chain's
    losses and gradients within the stated tolerances; a view-split step
    still takes the plain chain.

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
from mvgformer_tpu_torch.ops.dlt_jacobi import (fused_dlt, image_points,
                                                plain_dlt, solve_views)
from mvgformer_tpu_torch.tools.launch_cost import (DLT_SPACE_CENTER,
                                                   dlt_inputs, dlt_rig)
from mvgformer_tpu_torch.utils import profiling

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
    ops = all_zero(scale=scale)
    got, want = run_both(to(ops, cuda))
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    assert torch.equal(want[1], torch.zeros_like(want[1]))
    assert_close_inside(got[:1], want[:1], ops["mask"][:1])


def near_degenerate(N=256, seed=17):
    """Three cameras a micrometre apart seeing the same points: nearly the
    same ray, so the Gram matrix has a second eigenvalue near zero."""
    B, V = 1, 3
    ops = operands(B, N, V, seed=seed, noise_px=0.0, masked=0.0)
    vd, _ = dlt_rig(B, V, seed)
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
    return ops


def tied(N=32, seed=19):
    """Two views whose third projection rows vanish and whose first two
    rows are e0, e1 and e2, e3: with equal weights the equilibrated Gram
    matrix is the identity, four tied eigenvalues. torch.argmin takes the
    first, e0, which dehomogenises to (inf, nan, nan); the last would give
    the origin."""
    B, V = 1, 2
    ops = operands(B, N, V, seed=seed, masked=0.0)
    proj = torch.zeros(B, V, 3, 4)
    proj[0, 0, 0, 0] = proj[0, 0, 1, 1] = 1.0
    proj[0, 1, 0, 2] = proj[0, 1, 1, 3] = 1.0
    ops.update(proj=proj, logits=torch.zeros(V, B, N))
    return ops


def all_zero(N=64, seed=13, scale=0.0):
    """Frame 1's projections vanish (or fall under the guard's 1e-10):
    its system is all zero, and the plain chain's substituted rows solve
    to the origin."""
    ops = operands(2, N, 5, seed=seed, masked=0.0)
    ops["proj"] = ops["proj"].clone()
    ops["proj"][1] = ops["proj"][1] / ops["proj"][1].abs().amax() * scale
    return ops


@pytest.mark.gpu
def test_fused_dlt_near_degenerate_gram_is_finite(cuda):
    """Three cameras a micrometre apart (`near_degenerate`): both paths
    stay finite."""
    got, want = run_both(to(near_degenerate(), cuda))
    assert torch.isfinite(got).all()
    assert torch.isfinite(want).all()


@pytest.mark.gpu
def test_fused_dlt_eigenvalue_ties_take_the_first_index(cuda):
    """The identity Gram matrix of `tied`: the first index, as
    torch.argmin."""
    got, want = run_both(to(tied(), cuda))
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
    for name in ("proj", "inv_affine"):
        with pytest.raises(ValueError, match="requires grad"):
            fused_dlt(**dict(ops, refined=ops["refined"].requires_grad_(),
                             **{name: ops[name].requires_grad_()}))
    with pytest.raises(ValueError, match="requires grad"):
        cams = ops["cameras"]
        fused_dlt(**dict(ops, cameras=CameraParams(
            R=cams.R, T=cams.T, f=cams.f.requires_grad_(), c=cams.c,
            k=cams.k, p=cams.p)))
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


# ---------------------------------------------------------------------------
# The backward kernel's rule in Python: csrc/dlt_jacobi.cu's
# dlt_jacobi_bwd_kernel per point, in its order, each scalar a tensor over
# the points. Steps (1)-(3) and the system run in the inputs' dtype and the
# solve in `solve_dtype`, cast where the plain chain casts to float32
# (`triangulate_dlt`'s `.float()`); the kernel runs all of it in float32.

PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
SWEEPS, ITERS = 6, 5


def _sign(x):
    """The kernel's sign: 0 at 0 and NaN."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, 0.0)).to(x.dtype)


def _nan_max(a, b):
    """torch.amax's maximum: a NaN wins."""
    return torch.where((a > b) | a.isnan(), a, b)


def _key(i, j):
    return (i, j) if i <= j else (j, i)


def _rotation(a, p, q):
    """The scalars of rotation (p, q) from the state before it."""
    app, aqq, apq = a[p, p], a[q, q], a[p, q]
    small = apq.abs() <= 1e-12 * (app.abs() + aqq.abs()) + 1e-15
    den = 2.0 * torch.where(small, 1.0, apq)
    num = aqq - app
    tau = num / den
    sgn = _sign(tau)
    root = torch.sqrt(1.0 + tau * tau)
    dd = tau.abs() + root
    t = torch.where(small, 0.0, torch.where(tau == 0, 1.0, sgn / dd))
    q_ = torch.sqrt(1.0 + t * t)
    c = 1.0 / q_
    return dict(small=small, num=num, den=den, tau=tau, sgn=sgn, root=root,
                dd=dd, t=t, q=q_, c=c, s=t * c)


def _rotate(a, v, p, q):
    k = _rotation(a, p, q)
    t, c, s = k["t"], k["c"], k["s"]
    a, v = dict(a), dict(v)
    app, aqq, apq = a[p, p], a[q, q], a[p, q]
    a[p, p] = app - t * apq
    a[q, q] = aqq + t * apq
    a[p, q] = torch.where(k["small"], apq, 0.0)
    for r in range(4):
        if r in (p, q):
            continue
        rp, rq = _key(r, p), _key(r, q)
        arp, arq = a[rp], a[rq]
        a[rp], a[rq] = c * arp - s * arq, s * arp + c * arq
    for r in range(4):
        vrp, vrq = v[r, p], v[r, q]
        v[r, p], v[r, q] = c * vrp - s * vrq, s * vrp + c * vrq
    return a, v


def _rotate_bwd(a, v, da, dv, p, q):
    """The kernel's rotate_bwd<p, q>: da, dv from after the rotation to
    before it, in place; a, v the state before it."""
    k = _rotation(a, p, q)
    small, t, c, s = k["small"], k["t"], k["c"], k["s"]
    gc = gs = 0.0
    for r in range(4):
        if r in (p, q):
            continue
        rp, rq = _key(r, p), _key(r, q)
        arp, arq, gp, gq = a[rp], a[rq], da[rp], da[rq]
        gc = gc + gp * arp + gq * arq
        gs = gs - gp * arq + gq * arp
        da[rp], da[rq] = c * gp + s * gq, c * gq - s * gp
    for r in range(4):
        vrp, vrq, gp, gq = v[r, p], v[r, q], dv[r, p], dv[r, q]
        gc = gc + gp * vrp + gq * vrq
        gs = gs - gp * vrq + gq * vrp
        dv[r, p], dv[r, q] = c * gp + s * gq, c * gq - s * gp
    apq = a[p, q]
    gpp, gqq, gpq = da[p, p], da[q, q], da[p, q]
    gt = gqq * apq - gpp * apq
    gapq = gqq * t - gpp * t + torch.where(small, gpq, 0.0)
    gt = gt + gs * c
    gc = gc + gs * t
    gu = (-gc * (c * c)) / (2.0 * k["q"])
    gt = gt + gu * t + gu * t
    gt0 = torch.where(small | (k["tau"] == 0), 0.0, gt)
    sgn, dd, tau, den = k["sgn"], k["dd"], k["tau"], k["den"]
    gdd = -gt0 * ((sgn / dd) / dd)
    gw = gdd / (2.0 * k["root"])
    gtau = gdd * sgn + gw * tau + gw * tau
    gnum = gtau / den
    gden = -gtau * ((k["num"] / den) / den)
    da[p, q] = torch.where(small, gapq, gapq + gden * 2.0)
    da[p, p] = gpp - gnum
    da[q, q] = gqq + gnum


def _per_view(t, v, *idx, N):
    """(B, V, ...) -> view v's entry idx for each of the B * N points."""
    return t[(slice(None), v) + idx].repeat_interleave(N)


def _undistort_iterates(cam, x, y):
    m, fx, fy, cx, cy, k1, k2, k3, p1, p2 = cam
    ox = x * m[0] + y * m[1] + m[2]
    oy = x * m[3] + y * m[4] + m[5]
    x0, y0 = (ox - cx) / fx, (oy - cy) / fy
    xs, ys = [x0], [y0]
    for _ in range(ITERS):
        xu, yu = xs[-1], ys[-1]
        r2 = xu * xu + yu * yu
        icdist = 1.0 / (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2)
        dx = 2.0 * p1 * xu * yu + p2 * (r2 + 2.0 * xu * xu)
        dy = p1 * (r2 + 2.0 * yu * yu) + 2.0 * p2 * xu * yu
        xs.append((x0 - dx) * icdist)
        ys.append((y0 - dy) * icdist)
    return x0, y0, xs, ys


def _undistort_bwd(cam, x0, y0, xs, ys, gux, guy):
    m, fx, fy, cx, cy, k1, k2, k3, p1, p2 = cam
    gx, gy = gux * fx, guy * fy
    gx0 = gy0 = 0.0
    for it in reversed(range(ITERS)):
        xu, yu = xs[it], ys[it]
        r2 = xu * xu + yu * yu
        h1 = k3 * r2 + k2
        h2 = h1 * r2 + k1
        icdist = 1.0 / (1.0 + h2 * r2)
        dx = 2.0 * p1 * xu * yu + p2 * (r2 + 2.0 * xu * xu)
        dy = p1 * (r2 + 2.0 * yu * yu) + 2.0 * p2 * xu * yu
        gnx, gny = gx * icdist, gy * icdist
        gic = gx * (x0 - dx) + gy * (y0 - dy)
        gx0, gy0 = gx0 + gnx, gy0 + gny
        gden = -gic * (icdist * icdist)
        gh2 = gden * r2
        gh1 = gh2 * r2
        gr2 = gden * h2 + gh2 * h1 + gh1 * k3
        gdx, gdy = -gnx, -gny
        tx, ty = gdx * p2, gdy * p1
        gr2 = gr2 + tx + ty
        gxi = (gdx * yu * (2.0 * p1) + tx * xu * 2.0 + tx * (2.0 * xu)
               + gdy * yu * (2.0 * p2))
        gyi = (gdx * (2.0 * p1 * xu) + ty * yu * 2.0 + ty * (2.0 * yu)
               + gdy * (2.0 * p2 * xu))
        gx = gxi + gr2 * xu + gr2 * xu
        gy = gyi + gr2 * yu + gr2 * yu
    gx0, gy0 = gx0 + gx, gy0 + gy
    gox, goy = gx0 / fx, gy0 / fy
    return gox * m[0] + goy * m[3], gox * m[1] + goy * m[4]


def _clip_scale(n, max_norm):
    ratio = (1.0 / torch.where(n < 1e-30, 1e-30, n)) * max_norm
    return torch.where(ratio > 1.0, 1.0, ratio)


def kernel_backward(refined, logits, mask, inv_affine, cameras, proj, grad,
                    grad_clip=None, solve_dtype=torch.float32):
    """(d_refined (V, B, N, 2), d_logits (V, B, N)) as the backward kernel
    computes them for the cotangent `grad` (B, N, 3) of `fused_dlt`'s
    output; the solve in `solve_dtype`."""
    V, B, N, _ = refined.shape
    dt = refined.dtype
    f32 = solve_dtype

    def pv(t, v, *idx):
        return _per_view(t, v, *idx, N=N)

    cams, it8 = [], []
    ux, uy, w = [], [], []
    for v in range(V):
        cam = ([pv(inv_affine, v, i, j) for i in range(2) for j in range(3)],
               pv(cameras.f, v, 0), pv(cameras.f, v, 1),
               pv(cameras.c, v, 0), pv(cameras.c, v, 1),
               pv(cameras.k, v, 0), pv(cameras.k, v, 1),
               pv(cameras.k, v, 2), pv(cameras.p, v, 0),
               pv(cameras.p, v, 1))
        x0, y0, xs, ys = _undistort_iterates(
            cam, refined[v, ..., 0].reshape(-1), refined[v, ..., 1].reshape(-1))
        cams.append(cam)
        it8.append((x0, y0, xs, ys))
        ux.append(cam[1] * xs[-1] + cam[3])
        uy.append(cam[2] * ys[-1] + cam[4])
        w.append(logits[v].reshape(-1))
    lmax = w[0]
    for v in range(1, V):
        lmax = torch.maximum(lmax, w[v])
    w = [torch.exp(wv - lmax) for wv in w]
    total = w[0]
    for wv in w[1:]:
        total = total + wv
    w = [wv / total for wv in w]

    def rows():
        """Each system row's e (dt), A = e w (float32, the chain's cast),
        and the row's view and P[2]."""
        for v in range(V):
            for r in range(2):
                u = ux[v] if r == 0 else uy[v]
                p2 = [pv(proj, v, 2, j) for j in range(4)]
                e = [p2[j] * u - pv(proj, v, r, j) for j in range(4)]
                yield v, e, [(e[j] * w[v]).to(f32) for j in range(4)], p2

    amax = [torch.zeros(B * N, dtype=f32) for _ in range(4)]
    for _, _, A, _ in rows():
        amax = [_nan_max(amax[j], A[j].abs()) for j in range(4)]
    degenerate = _nan_max(_nan_max(amax[0], amax[1]),
                          _nan_max(amax[2], amax[3])) < 1e-10
    cs = [m + 1e-12 for m in amax]

    a = {(i, j): torch.zeros(B * N, dtype=f32)
         for i in range(4) for j in range(i, 4)}
    for _, _, A, _ in rows():
        an = [A[j] / cs[j] for j in range(4)]
        for i in range(4):
            for j in range(i, 4):
                a[i, j] = a[i, j] + an[i] * an[j]
    one, zero = torch.ones(B * N, dtype=f32), torch.zeros(B * N, dtype=f32)
    rot = {(r, c): one if r == c else zero for r in range(4) for c in range(4)}
    firsts = []
    for _ in range(SWEEPS):
        firsts.append((a, rot))
        for p, q in PAIRS:
            a, rot = _rotate(a, rot, p, q)
    best = torch.zeros(B * N, dtype=torch.long)
    low = a[0, 0]
    for j in range(1, 4):
        d = a[j, j]
        take = ~low.isnan() & ((d < low) | d.isnan())
        low = torch.where(take, d, low)
        best = torch.where(take, j, best)
    x = []
    for r in range(4):
        col = rot[r, 0]
        for j in range(1, 4):
            col = torch.where(best == j, rot[r, j], col)
        x.append(col / cs[r])

    go = [grad[..., k].reshape(-1).to(f32) for k in range(3)]
    gx = [go[k] / x[3] for k in range(3)] + [zero]
    for k in range(3):
        gx[3] = gx[3] - go[k] * ((x[k] / x[3]) / x[3])
    dcs = [-gx[r] * (x[r] / cs[r]) for r in range(4)]
    da = {key: zero for key in a}
    dv = {(r, j): torch.where(best == j, gx[r] / cs[r], 0.0)
          for r in range(4) for j in range(4)}
    for first_a, first_v in reversed(firsts):
        for j in reversed(range(len(PAIRS))):
            sa, sv = first_a, first_v
            for p, q in PAIRS[:j]:
                sa, sv = _rotate(sa, sv, p, q)
            _rotate_bwd(sa, sv, da, dv, *PAIRS[j])

    def dg(i, j):
        return da[i, j] if j >= i else zero

    def gram_bwd(A):
        an = [A[j] / cs[j] for j in range(4)]
        out = []
        for k in range(4):
            left = right = zero
            for j in range(4):
                left = left + an[j] * dg(k, j)
                right = right + an[j] * dg(j, k)
            out.append(left + right)
        return an, out

    ties = [zero] * 4
    for _, _, A, _ in rows():
        an, dan = gram_bwd(A)
        for k in range(4):
            dcs[k] = dcs[k] - dan[k] * (an[k] / cs[k])
            ties[k] = ties[k] + (A[k].abs() == amax[k]).to(f32)
    gu = [[0.0, 0.0] for _ in range(V)]
    gw = [0.0] * V
    row = 0
    for v, e, A, p2 in rows():
        _, dan = gram_bwd(A)
        g = 0.0
        for k in range(4):
            at_max = (A[k].abs() == amax[k]).to(f32)
            gA = (dan[k] / cs[k] + (dcs[k] / ties[k]) * at_max
                  * _sign(A[k])).to(dt)
            gw[v] = gw[v] + gA * e[k]
            g = g + (gA * w[v]) * p2[k]
        gu[v][row % 2] = g
        row += 1
    if grad_clip is not None:
        for v in range(V):
            n = torch.linalg.vector_norm(torch.stack(gu[v], -1).to(f32),
                                         dim=-1)
            scale = _clip_scale(n, grad_clip).to(dt)
            gu[v] = [gu[v][0] * scale, gu[v][1] * scale]
            gw[v] = gw[v] * _clip_scale(gw[v].to(f32).abs(),
                                        grad_clip).to(dt)
    dot = 0.0
    for v in range(V):
        dot = dot + gw[v] * w[v]

    keep = (mask.reshape(-1) & ~degenerate)
    d_refined, d_logits = [], []
    for v in range(V):
        x0, y0, xs, ys = it8[v]
        grx, gry = _undistort_bwd(cams[v], x0, y0, xs, ys, *gu[v])
        d_refined.append(torch.stack([torch.where(keep, grx, 0.0),
                                      torch.where(keep, gry, 0.0)], -1))
        d_logits.append(torch.where(keep, w[v] * (gw[v] - dot), 0.0))
    return (torch.stack(d_refined).reshape(V, B, N, 2),
            torch.stack(d_logits).reshape(V, B, N))


def as_float64(ops):
    out = {k: v.double() if v.is_floating_point() else v
           for k, v in ops.items() if k != "cameras"}
    out["cameras"] = CameraParams(**{
        name: getattr(ops["cameras"], name).double()
        for name in ("R", "T", "f", "c", "k", "p")})
    return out


def lift_float32_casts(monkeypatch):
    """The plain chain in the inputs' dtype throughout: its casts to
    float32 (`triangulate_dlt`'s and `jacobi4_smallest`'s `.float()`, the
    clip's norm) become the identity until the monkeypatch is undone."""
    monkeypatch.setattr(torch.Tensor, "float", lambda self: self)


def autograd_grads(ops, grad, grad_clip=None):
    """torch.autograd's (d_refined, d_logits) through the plain chain:
    `plain_dlt`, or with a clip `image_points` + `solve_views`, masked-out
    points standing in at the corner as `plain_dlt`'s do."""
    refined = ops["refined"].detach().clone().requires_grad_()
    logits = ops["logits"].detach().clone().requires_grad_()
    if grad_clip is None:
        out = plain_dlt(**dict(ops, refined=refined, logits=logits))
    else:
        corner = torch.zeros((), dtype=refined.dtype, device=refined.device)
        points = image_points(refined, ops["mask"], corner,
                              ops["inv_affine"], ops["cameras"])
        out = solve_views(points, logits, ops["mask"], ops["proj"],
                          "jacobi", grad_clip)
    out.backward(grad.to(out.dtype))
    return refined.grad, logits.grad


def cotangent(B, N, seed, scale=1.0, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(B, N, 3, generator=gen)).to(device)


def tau_zero(N=16, seed=61):
    """Three views at equal weights. The first two have no third
    projection row and rows (1, 0, 0, 1), (0, 1, 0, 1) and (0, 0, 1, 1),
    (1, -1, 0, 0); the third rows (0, 0, 1, 0), (0, 0, 0, 0) under a third
    row e3, so only column 3 reads its point. The Gram matrix has G00 ==
    G11 and G01 != 0, so the first rotation takes tau == 0 (45 degrees),
    and the third view's point and every logit take a cotangent."""
    B, V = 1, 3
    ops = operands(B, N, V, seed=seed, masked=0.0)
    proj = torch.zeros(B, V, 3, 4)
    proj[0, 0, :2] = torch.tensor([[1.0, 0, 0, 1], [0, 1, 0, 1]])
    proj[0, 1, :2] = torch.tensor([[0.0, 0, 1, 1], [1, -1, 0, 0]])
    proj[0, 2, 0, 2] = proj[0, 2, 2, 3] = 1.0
    ops.update(proj=proj, logits=torch.zeros(V, B, N))
    return ops


def reorder_views(ops, order):
    """The same systems with the views in `order`."""
    cams = ops["cameras"]
    return dict(
        ops, refined=ops["refined"][order].contiguous(),
        logits=ops["logits"][order].contiguous(),
        inv_affine=ops["inv_affine"][:, order].contiguous(),
        proj=ops["proj"][:, order].contiguous(),
        cameras=CameraParams(**{name: getattr(cams, name)[:, order]
                                .contiguous()
                                for name in ("R", "T", "f", "c", "k", "p")}))


RULE_CASES = {
    "random_v3": lambda: operands(2, 64, 3, seed=31),
    "random_v5": lambda: operands(2, 64, 5, seed=32),
    "random_v10": lambda: operands(2, 64, 10, seed=33),
    "near_degenerate": lambda: near_degenerate(N=64),
    "ties": tied,
    "tau_zero": tau_zero,
    "all_zero": all_zero,
    "masked": lambda: operands(2, 64, 5, seed=34, masked=1.0),
    "clip": lambda: operands(2, 64, 5, seed=35),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_backward_rule_matches_autograd(monkeypatch, case):
    """`kernel_backward` against autograd through the plain chain, both in
    float64. The two differ by float64 rounding alone: the ops are the
    same and only the order of a few sums (the Gram matrix's, autograd's
    accumulation of a tensor's uses) differs, so the bound is 1e-9 of the
    largest entry and 1e-7 of each; measured at most 4e-12 of the largest
    on the random systems.

    The near-degenerate Gram matrix is the exception. Its null vector is
    ill-defined (the points land 1e9 mm out) and the VJP of the fixed
    sweeps there turns on every rounding: autograd disagrees with itself
    when only the views' order changes (up to 1e3 of a point's gradient).
    There the rule's gradient is finite and, at the median point and the
    worst, no farther from autograd's than autograd's is from itself with
    the views reordered."""
    ops = as_float64(RULE_CASES[case]())
    B, N = ops["mask"].shape
    clip = 1.0 if case == "clip" else None
    # a cotangent large enough that the clip engages
    grad = cotangent(B, N, seed=7, scale=100.0 if clip else 1.0)
    got = kernel_backward(**ops, grad=grad, grad_clip=clip,
                          solve_dtype=torch.float64)
    order = [2, 0, 1]
    with monkeypatch.context() as m:
        lift_float32_casts(m)
        want = autograd_grads(ops, grad, clip)
        if case == "near_degenerate":
            back = [order.index(v) for v in range(3)]
            again = [g[back] for g in autograd_grads(
                reorder_views(ops, order), grad)]
    mask = ops["mask"]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float64
        # masked-out points: exact zeros in both
        assert torch.equal(g[:, ~mask], torch.zeros_like(g[:, ~mask]))
        assert torch.equal(w[:, ~mask], torch.zeros_like(w[:, ~mask]))
        assert torch.equal(g.isnan(), w.isnan())
    if case == "near_degenerate":
        for g, w, a in zip(got, want, again):
            assert torch.isfinite(g).all() and torch.isfinite(w).all()
            ours, theirs = point_errors(g, w, mask), point_errors(a, w, mask)
            assert ours.median() <= theirs.median(), (ours, theirs)
            assert ours.max() <= theirs.max(), (ours, theirs)
        return
    for g, w in zip(got, want):
        finite = ~w.isnan()
        scale = w[finite].abs().amax() if finite.any() else 0.0
        err = (g[finite] - w[finite]).abs()
        assert (err <= 1e-9 * scale + 1e-7 * w[finite].abs()).all(), (
            case, float(err.max()), float(scale))
    if case in ("random_v3", "random_v5", "random_v10", "tau_zero",
                "clip"):
        assert all(torch.isfinite(g).all() for g in got)
        assert got[1].abs().amax() > 0
    if case == "tau_zero":
        # the first two views' rows do not read their points
        assert torch.equal(got[0][:2], torch.zeros_like(got[0][:2]))
        assert got[0][2].abs().amax() > 0
    if case == "ties":
        # e0 at the first index: x3 = 0, so no finite cotangent
        assert got[0].isnan().any()
    if case == "all_zero":
        # frame 1's system is all zero: the origin, no cotangent
        assert torch.equal(got[0][:, 1], torch.zeros_like(got[0][:, 1]))
        assert torch.equal(got[1][:, 1], torch.zeros_like(got[1][:, 1]))
        assert got[0][:, 0].abs().amax() > 0
    if case == "masked":
        assert not mask.any()
    if case == "clip":
        unclipped = kernel_backward(**ops, grad=grad,
                                    solve_dtype=torch.float64)
        assert not torch.allclose(unclipped[0], got[0])
        assert got[1].abs().amax() <= 1.0  # |d logit| <= |d weight|


# the card: the backward kernel

def kernel_grads(ops, grad, grad_clip=None):
    """(d_refined, d_logits) of `fused_dlt` on the card: one forward and
    one backward launch."""
    refined = ops["refined"].detach().clone().requires_grad_()
    logits = ops["logits"].detach().clone().requires_grad_()
    launches = fused_dlt.launches
    backward = profiling.COUNTERS[dlt_jacobi.BACKWARD_COUNTER]
    out = fused_dlt(**dict(ops, refined=refined, logits=logits),
                    grad_clip=grad_clip)
    assert out.requires_grad
    out.backward(grad)
    torch.cuda.synchronize()
    assert fused_dlt.launches == launches + 1
    assert profiling.COUNTERS[dlt_jacobi.BACKWARD_COUNTER] == backward + 1
    return refined.grad, logits.grad


def point_errors(got, want, mask):
    """Each kept point's |got - want| / |want| over its views' entries."""
    def rows(t):
        return t.movedim(0, 2).reshape(mask.numel(), -1)[mask.reshape(-1)]
    g, w = rows(got.double()), rows(want.double())
    norm = w.norm(dim=1)
    keep = norm > 0
    return (g - w)[keep].norm(dim=1) / norm[keep]


QUANTILES = torch.tensor([0.5, 0.9, 0.99, 1.0], dtype=torch.float64)


def assert_as_close_as_autograd(ops, grad, grad_clip, cuda, monkeypatch):
    """The kernel's gradient lies as close to the float64 gradient (the
    plain chain with its float32 casts lifted) as the plain chain's own
    float32 autograd does: at each quantile of the points' relative
    errors within 2x of autograd's, and 4x at the worst point. Float32
    rounding through 36 rotations and the softmax's cancellation leave
    autograd itself 1e-4 to 3e-1 off at the worst points (the CPU rule:
    1.0-1.2x of autograd at every quantile), so no fixed tolerance
    separates a fault from rounding; the chain's own error does."""
    got = kernel_grads(ops, grad, grad_clip)
    plain = autograd_grads(ops, grad, grad_clip)
    with monkeypatch.context() as m:
        lift_float32_casts(m)
        truth = autograd_grads(as_float64(ops), grad.double(), grad_clip)
    mask = ops["mask"]
    for name, g, p, t in zip(("refined", "logits"), got, plain, truth):
        assert torch.isfinite(g[:, mask]).all(), name
        assert torch.equal(g[:, ~mask], torch.zeros_like(g[:, ~mask]))
        ours = torch.quantile(point_errors(g, t, mask), QUANTILES.to(cuda))
        theirs = torch.quantile(point_errors(p, t, mask),
                                QUANTILES.to(cuda))
        bound = theirs * torch.tensor([2.0, 2.0, 2.0, 4.0],
                                      dtype=torch.float64,
                                      device=cuda) + 1e-7
        assert (ours <= bound).all(), (name, ours.tolist(),
                                       theirs.tolist())


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,V", [(1, 15360, 5), (2, 960, 3),
                                   (1, 960, 10)])
def test_backward_kernel_matches_autograd(cuda, monkeypatch, B, N, V):
    """At the training layer's shape (1 x 1024 queries x 15 joints, 5
    views), at V 3 and B 2, and at the most views the kernel takes."""
    ops = to(operands(B, N, V, seed=B * 100 + V + 1), cuda)
    grad = cotangent(B, N, seed=V, device=cuda)
    assert_as_close_as_autograd(ops, grad, None, cuda, monkeypatch)


@pytest.mark.gpu
def test_backward_kernel_clip_matches_solve_views(cuda, monkeypatch):
    """TRI_GRAD_CLIP 1.0 against `image_points` + `solve_views` with the
    clip, the cotangent large enough that it engages."""
    ops = to(operands(1, 15360, 5, seed=41), cuda)
    grad = cotangent(1, 15360, seed=41, scale=100.0, device=cuda)
    assert_as_close_as_autograd(ops, grad, 1.0, cuda, monkeypatch)
    unclipped = kernel_grads(ops, grad)
    clipped = kernel_grads(ops, grad, 1.0)
    assert not torch.allclose(unclipped[0], clipped[0])


@pytest.mark.gpu
def test_backward_kernel_near_degenerate_gram_is_finite(cuda):
    ops = to(near_degenerate(), cuda)
    got = kernel_grads(ops, cotangent(1, 256, seed=43, device=cuda))
    want = autograd_grads(ops, cotangent(1, 256, seed=43, device=cuda))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert torch.isfinite(w).all()


@pytest.mark.gpu
def test_backward_kernel_masked_points_are_exact_zeros(cuda):
    for masked in (0.3, 1.0):
        ops = to(operands(2, 960, 5, seed=47, masked=masked), cuda)
        got = kernel_grads(ops, cotangent(2, 960, seed=47, device=cuda))
        mask = ops["mask"]
        for g in got:
            assert torch.equal(g[:, ~mask], torch.zeros_like(g[:, ~mask]))
            assert torch.isfinite(g).all()


@pytest.mark.gpu
def test_backward_kernel_all_zero_system_sends_nothing(cuda):
    ops = to(all_zero(), cuda)
    got = kernel_grads(ops, cotangent(2, 64, seed=53, device=cuda))
    for g in got:
        assert torch.equal(g[:, 1], torch.zeros_like(g[:, 1]))
        assert g[:, 0].abs().amax() > 0


@pytest.mark.gpu
def test_backward_kernel_makes_no_sync(cuda):
    ops = to(operands(1, 15360, 5, seed=59), cuda)
    grad = cotangent(1, 15360, seed=59, device=cuda)
    kernel_grads(ops, grad)  # built and loaded outside the count
    refined = ops["refined"].clone().requires_grad_()

    def step():
        fused_dlt(**dict(ops, refined=refined), grad_clip=1.0).backward(grad)

    _, syncs = profiling.count_syncs(step)
    assert syncs == 0


def training_step(cfg, cuda, remat=True):
    """One toy training step on the card from seed 0: its metrics, the
    first gradients (Adam's first moments after one step) and the DLT's
    counts over it."""
    from mvgformer_tpu_torch.core.train import (create_train_state,
                                                make_train_step)
    from mvgformer_tpu_torch.models import build_model

    cfg.PARALLEL.REMAT_DECODER = remat
    model = build_model(cfg, generator=torch.Generator().manual_seed(0),
                        device=cuda)
    state, tx = create_train_state(cfg, model)
    step = make_train_step(cfg, model, tx)
    batch = make_batch(cfg, batch_size=1, seed=5, device=cuda)
    before = (fused_dlt.launches, fused_dlt.plain_calls,
              profiling.COUNTERS[dlt_jacobi.BACKWARD_COUNTER])
    state, metrics = step(state, batch, torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    counts = (fused_dlt.launches - before[0],
              fused_dlt.plain_calls - before[1],
              profiling.COUNTERS[dlt_jacobi.BACKWARD_COUNTER] - before[2])
    grads = {k: v.detach().clone() for k, v in state.opt_state.mu.items()}
    return metrics, grads, counts


def train_cfg():
    cfg = toy_cfg()
    cfg.DECODER.inference_topk_queries = None
    return cfg


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [True, False])
def test_training_step_launches_the_kernels(cuda, remat):
    """Under remat each layer's forward launches the kernel, its recompute
    in the backward launches it again, then its backward kernel once;
    without remat once each. No call takes the plain chain."""
    cfg = train_cfg()
    metrics, _, counts = training_step(cfg, cuda, remat)
    layers = cfg.DECODER.num_decoder_layers
    assert counts == ((2 if remat else 1) * layers, 0, layers)
    assert torch.isfinite(torch.as_tensor(metrics["total"]))


@pytest.mark.gpu
@pytest.mark.parametrize("clip", [None, 1.0])
def test_training_step_matches_the_plain_chain(cuda, monkeypatch, clip):
    """The toy step with the kernels against the same step with
    `fused_path` forced False (the plain chain and its autograd), with
    and without TRI_GRAD_CLIP: the losses within 1e-4 relative, and each
    leaf's gradient within 1e-2 of its norm, 1e-3 at the median leaf (the
    DLT's float32 rounding, forward and backward, carried through four
    layers and the matching)."""
    cfg = train_cfg()
    cfg.TRAIN.TRI_GRAD_CLIP = clip
    got, got_grads, counts = training_step(cfg, cuda)
    assert counts[1] == 0 and counts[2] > 0
    monkeypatch.setattr(dlt_jacobi, "fused_path", lambda *a: False)
    want, want_grads, counts = training_step(cfg, cuda)
    assert counts == (0, 0, 0)
    for key in want:
        a, b = float(got[key]), float(want[key])
        assert abs(a - b) <= 1e-4 * abs(b) + 1e-6, (key, a, b)
    gaps = {}
    for key, w in want_grads.items():
        norm = float(w.norm())
        gaps[key] = float((got_grads[key] - w).norm()) / norm if norm else (
            float(got_grads[key].norm()))
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= 1e-2, (worst, gaps[worst])
    median = sorted(gaps.values())[len(gaps) // 2]
    assert median <= 1e-3, median


def _view_split_rank(dp):
    """A rank of a 1 x 2 view grid: one toy training step on its two of
    four views; the DLT's counts over it."""
    from mvgformer_tpu_torch.core.train import (create_train_state,
                                                make_train_step)
    from mvgformer_tpu_torch.models import build_model
    from mvgformer_tpu_torch.parallel import shard_batch

    cfg = train_cfg()
    cfg.DATASET.CAMERA_NUM = 4
    model = build_model(cfg, generator=torch.Generator().manual_seed(0),
                        device=dp.device)
    state, tx = create_train_state(cfg, model)
    step = make_train_step(cfg, model, tx, num_replicas=2, dp=dp)
    local = shard_batch(make_batch(cfg, batch_size=1, seed=5, device="cpu"),
                        dp).to(dp.device)
    before = (fused_dlt.launches, fused_dlt.plain_calls,
              profiling.COUNTERS[dlt_jacobi.BACKWARD_COUNTER])
    _, metrics = step(state, local, torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    return {"total": float(metrics["total"]),
            "counts": (fused_dlt.launches - before[0],
                       fused_dlt.plain_calls - before[1],
                       profiling.COUNTERS[dlt_jacobi.BACKWARD_COUNTER]
                       - before[2]),
            "layers": cfg.DECODER.num_decoder_layers,
            "remat": cfg.PARALLEL.REMAT_DECODER}


@pytest.mark.gpu
def test_view_split_training_keeps_the_plain_chain(cuda):
    """Two ranks sharing the card over gloo, each with two of the four
    views: every layer's DLT needs the other rank's views, so the step
    takes the plain chain and counts each call, the remat recompute's
    too; nothing launches."""
    from mvgformer_tpu_torch.parallel.mesh import spawn

    out = spawn(_view_split_rank, 2, "cuda", views=2)
    calls = out["layers"] * (2 if out["remat"] else 1)
    assert out["counts"] == (0, calls, 0)
    assert torch.isfinite(torch.tensor(out["total"]))
