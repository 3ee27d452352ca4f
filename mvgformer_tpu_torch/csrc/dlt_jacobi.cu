// The Jacobi DLT, forward and backward, for Hopper (sm_90a): steps 8-9 of
// a DQ decoder layer (mvgformer_tpu_torch/models/decoder.py) in one launch,
// and in training their VJP in one more.
//
// Replaces, for a call with every view on this process, the plain chain
// from the refined 2D points to the masked 3D points:
//
//   orig   = inv_affine[b, v] @ [refined[v, b, n], 1]        (net -> image px)
//   und    = undistort(orig, camera[b, v]), 5 fixed-point iterations
//   w      = softmax over v of logits[v, b, n]
//   A      = w_v * (und_r * P[b, v, 2, :] - P[b, v, r, :]),  2V x 4
//   A      = e0, e1 / 2, e2 / 4 if max |A| < 1e-10            (the origin)
//   G      = (A D)^T (A D), D = 1 / (column max |A| + 1e-12)
//   x      = the eigenvector of G's smallest eigenvalue, 6 cyclic Jacobi
//            sweeps, D x dehomogenised
//   out    = mask[b, n] ? x : 0
//
// which is ops/dlt_jacobi.py::plain_dlt, the layer's plain chain:
// image_points (step 8) then solve_views (step 9) with solver 'jacobi', in
// float32.
//
// What bounds it: launches, not the card. A served frame has 960 points
// (top-64 queries x 15 joints) per layer, 7,680 at batch 8, each a few
// hundred bytes of input; the plain chain issues ~2,650 elementwise
// launches per layer on them. Here one thread owns one point: its 2V
// coordinates, V weights, the Gram matrix's 10 entries and the 4 x 4
// rotation live in registers (every loop is unrolled to compile-time
// indices), the per-view camera, crop and projection numbers are read
// through the read-only cache (every thread of a block reads the same
// ones). Blocks of 32 threads, so 960 points reach 30 SMs.
//
// Arithmetic follows the plain chain op for op: IEEE division and sqrtf,
// and no contraction into fused multiply-adds (built with -fmad=false, see
// ops/_build.py), so each product and sum is rounded where torch rounds
// it. Sums run in view order. The two matmuls of the plain chain (the
// crop affine and the Gram matrix) are sums of 3 and 2V products whose
// order cuBLAS chooses: there the kernel and the plain chain may differ by
// rounding. The degenerate guard writes the origin, which is what the
// plain chain's substituted rows solve to, bit for bit. A masked-out point
// writes zeros: the plain chain triangulates a stand-in for it and then
// zeroes it, and no point reads another's.
//
// The backward (dlt_jacobi_bwd_kernel, training) is the VJP of the same
// chain as torch.autograd takes it through the plain ops, the cotangents
// of refined and logits from that of out. It keeps nothing from the
// forward launch: one thread per point recomputes (1)-(7) from the inputs,
// keeping each sweep's first state (6 x 26 floats of local memory), then
// runs the chain in reverse, op for op as autograd does: a rotation's
// state is replayed from its sweep's first state, torch.where passes
// nothing to the branch it did not take (small, tau == 0, the degenerate
// guard, the mask), abs and sign are torch's at 0, the column maxima split
// their cotangent among ties, the argmin passes none and the eigenvector's
// cotangent enters through the gathered column alone. So it is the VJP of
// the fixed sweeps, bounded where the Gram matrix is near degenerate, not
// the analytic eigenvector derivative with its 1 / (l_i - l_j) terms.
// TRAIN.TRI_GRAD_CLIP is an argument: each view's point and weight
// cotangent scaled by min(max_norm / max(n, 1e-30), 1), as the plain
// chain's clip_cotangent does. What bounds it: launches again. A training
// layer has 15,360 points (1,024 queries x 15 joints); a point's work is
// about 10^4 float32 operations, 0.16 GFLOP a launch, some 2.3 us at the
// card's float32 peak, under the launch floor: its bound is the floor.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxViews = 10;
constexpr int kThreads = 32;
constexpr int kSweeps = 6;
constexpr int kUndistortIters = 5;

struct Args {
  const float* refined;  // (V, B, N, 2), strides in elements below
  int64_t rs_v, rs_b, rs_n, rs_c;
  const float* logits;   // (V, B, N)
  int64_t ls_v, ls_b, ls_n;
  const bool* mask;      // (B, N), contiguous
  const float* inv_affine;  // (B, V, 2, 3)
  const float* f;        // (B, V, 2)
  const float* c;        // (B, V, 2)
  const float* k;        // (B, V, 3)
  const float* p;        // (B, V, 2)
  const float* proj;     // (B, V, 3, 4)
  float* out;            // (B, N, 3)
  int B, N, V;
};

// torch.amax's maximum: a NaN wins
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

// One rotation of jacobi4_smallest on the pair (P, Q). The matrix lives in
// a[i][j], i <= j; the rotation accumulates in v.
template <int P, int Q>
__device__ __forceinline__ void rotate(float (&a)[4][4], float (&v)[4][4]) {
  const float app = a[P][P], aqq = a[Q][Q], apq = a[P][Q];
  const bool small =
      fabsf(apq) <= 1e-12f * (fabsf(app) + fabsf(aqq)) + 1e-15f;
  const float safe = small ? 1.0f : apq;
  const float tau = (aqq - app) / (2.0f * safe);
  // torch.sign: 0 for 0 and NaN
  const float sgn = tau > 0.0f ? 1.0f : (tau < 0.0f ? -1.0f : 0.0f);
  float t = sgn / (fabsf(tau) + sqrtf(1.0f + tau * tau));
  if (tau == 0.0f) t = 1.0f;
  if (small) t = 0.0f;
  const float c = 1.0f / sqrtf(1.0f + t * t);
  const float s = t * c;
  a[P][P] = app - t * apq;
  a[Q][Q] = aqq + t * apq;
  a[P][Q] = small ? apq : 0.0f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (r == P || r == Q) continue;
    float& rp = r < P ? a[r][P] : a[P][r];
    float& rq = r < Q ? a[r][Q] : a[Q][r];
    const float arp = rp, arq = rq;
    rp = c * arp - s * arq;
    rq = s * arp + c * arq;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float vrp = v[r][P], vrq = v[r][Q];
    v[r][P] = c * vrp - s * vrq;
    v[r][Q] = s * vrp + c * vrq;
  }
}

// Row r (0: x, 1: y) of view v's two DLT rows, column j, before the
// weight: und_r * P[2][j] - P[r][j]
__device__ __forceinline__ float dlt_entry(const float* pm, float u, int r,
                                           int j) {
  return __ldg(pm + 8 + j) * u - __ldg(pm + 4 * r + j);
}

__global__ void __launch_bounds__(kThreads)
    dlt_jacobi_kernel(const Args g) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (int64_t)g.B * g.N) return;
  const int b = (int)(i / g.N);
  const int n = (int)(i - (int64_t)b * g.N);
  float* o = g.out + 3 * i;
  if (!g.mask[i]) {
    o[0] = 0.0f;
    o[1] = 0.0f;
    o[2] = 0.0f;
    return;
  }

  // (1) the inverse crop affine, (2) the undistortion, per view
  float ux[kMaxViews], uy[kMaxViews], w[kMaxViews];
#pragma unroll
  for (int v = 0; v < kMaxViews; ++v) {
    if (v >= g.V) break;
    const int bv = b * g.V + v;
    const float* pt = g.refined + v * g.rs_v + b * g.rs_b + n * g.rs_n;
    const float x = pt[0], y = pt[g.rs_c];
    const float* m = g.inv_affine + 6 * bv;
    const float ox = x * __ldg(m) + y * __ldg(m + 1) + __ldg(m + 2);
    const float oy = x * __ldg(m + 3) + y * __ldg(m + 4) + __ldg(m + 5);
    const float fx = __ldg(g.f + 2 * bv), fy = __ldg(g.f + 2 * bv + 1);
    const float cx = __ldg(g.c + 2 * bv), cy = __ldg(g.c + 2 * bv + 1);
    const float k1 = __ldg(g.k + 3 * bv), k2 = __ldg(g.k + 3 * bv + 1),
                k3 = __ldg(g.k + 3 * bv + 2);
    const float p1 = __ldg(g.p + 2 * bv), p2 = __ldg(g.p + 2 * bv + 1);
    const float x0 = (ox - cx) / fx, y0 = (oy - cy) / fy;
    float xu = x0, yu = y0;
#pragma unroll
    for (int it = 0; it < kUndistortIters; ++it) {
      const float r2 = xu * xu + yu * yu;
      const float icdist = 1.0f / (1.0f + ((k3 * r2 + k2) * r2 + k1) * r2);
      const float dx = 2.0f * p1 * xu * yu + p2 * (r2 + 2.0f * xu * xu);
      const float dy = p1 * (r2 + 2.0f * yu * yu) + 2.0f * p2 * xu * yu;
      xu = (x0 - dx) * icdist;
      yu = (y0 - dy) * icdist;
    }
    ux[v] = fx * xu + cx;
    uy[v] = fy * yu + cy;
    w[v] = g.logits[v * g.ls_v + b * g.ls_b + n * g.ls_n];
  }

  // (3) the softmax over views
  float lmax = w[0];
#pragma unroll
  for (int v = 1; v < kMaxViews; ++v)
    if (v < g.V) lmax = fmaxf(lmax, w[v]);
  float sum = 0.0f;
#pragma unroll
  for (int v = 0; v < kMaxViews; ++v) {
    if (v >= g.V) break;
    w[v] = expf(w[v] - lmax);
    sum += w[v];
  }
#pragma unroll
  for (int v = 0; v < kMaxViews; ++v)
    if (v < g.V) w[v] = w[v] / sum;

  // (4) the system's column maxima; the degenerate guard
  const float* pm_b = g.proj + (int64_t)12 * b * g.V;
  float cs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int v = 0; v < kMaxViews; ++v) {
    if (v >= g.V) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float u = r == 0 ? ux[v] : uy[v];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cs[j] = nan_max(cs[j],
                        fabsf(dlt_entry(pm_b + 12 * v, u, r, j) * w[v]));
    }
  }
  if (nan_max(nan_max(cs[0], cs[1]), nan_max(cs[2], cs[3])) < 1e-10f) {
    o[0] = 0.0f;
    o[1] = 0.0f;
    o[2] = 0.0f;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) cs[j] = cs[j] + 1e-12f;

  // (5) the Gram matrix of the equilibrated system, upper half
  float a[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[r][j] = 0.0f;
#pragma unroll
  for (int v = 0; v < kMaxViews; ++v) {
    if (v >= g.V) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float u = r == 0 ? ux[v] : uy[v];
      float an[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        an[j] = dlt_entry(pm_b + 12 * v, u, r, j) * w[v] / cs[j];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int j = ii; j < 4; ++j) a[ii][j] = a[ii][j] + an[ii] * an[j];
    }
  }

  // (6) the fixed cyclic Jacobi sweeps
  float rot[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) rot[r][j] = r == j ? 1.0f : 0.0f;
#pragma unroll 1
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    rotate<0, 1>(a, rot);
    rotate<0, 2>(a, rot);
    rotate<0, 3>(a, rot);
    rotate<1, 2>(a, rot);
    rotate<1, 3>(a, rot);
    rotate<2, 3>(a, rot);
  }

  // (7) torch.argmin of the diagonal (first index on ties, a NaN first),
  // its eigenvector, the column rescale, the dehomogenisation
  int best = 0;
  float low = a[0][0];
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    const float d = a[j][j];
    if (!isnan(low) && (d < low || isnan(d))) {
      low = d;
      best = j;
    }
  }
  float x[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    x[r] = rot[r][0];
#pragma unroll
    for (int j = 1; j < 4; ++j)
      if (best == j) x[r] = rot[r][j];
    x[r] = x[r] / cs[r];
  }
  o[0] = x[0] / x[3];
  o[1] = x[1] / x[3];
  o[2] = x[2] / x[3];
}


// ---------------------------------------------------------------------------
// The backward: the VJP of the chain above, for a training call.

// jacobi4_smallest's rotations of a sweep, in its order
constexpr int kPairP[6] = {0, 0, 0, 1, 1, 2};
constexpr int kPairQ[6] = {1, 2, 3, 2, 3, 3};
constexpr int kPairs = 6;
// a sweep's first state: a's upper half (10 entries), then v (16)
constexpr int kState = 26;

struct BwdArgs {
  Args f;              // the forward's operands; f.out is not read
  const float* grad;   // (B, N, 3), the cotangent of out
  int64_t gs_b, gs_n, gs_c;
  float* d_refined;    // (V, B, N, 2), contiguous
  float* d_logits;     // (V, B, N), contiguous
  float max_norm;      // TRI_GRAD_CLIP, read where clip is set
  int clip;
};

// view v's crop affine and camera in frame b (bv = b * V + v)
struct View {
  float m[6];
  float fx, fy, cx, cy, k1, k2, k3, p1, p2;
};

__device__ __forceinline__ View load_view(const Args& g, int bv) {
  View c;
#pragma unroll
  for (int j = 0; j < 6; ++j) c.m[j] = __ldg(g.inv_affine + 6 * bv + j);
  c.fx = __ldg(g.f + 2 * bv);
  c.fy = __ldg(g.f + 2 * bv + 1);
  c.cx = __ldg(g.c + 2 * bv);
  c.cy = __ldg(g.c + 2 * bv + 1);
  c.k1 = __ldg(g.k + 3 * bv);
  c.k2 = __ldg(g.k + 3 * bv + 1);
  c.k3 = __ldg(g.k + 3 * bv + 2);
  c.p1 = __ldg(g.p + 2 * bv);
  c.p2 = __ldg(g.p + 2 * bv + 1);
  return c;
}

// (1)-(2) of the forward for one view, its arithmetic op for op: the net
// point (x, y) through the inverse crop affine, normalised to (x0, y0),
// and the undistortion's iterates: (xs[it], ys[it]) enter iteration it,
// (xs[kUndistortIters], ys[kUndistortIters]) leave the last.
__device__ __forceinline__ void undistort_iterates(
    const View& c, float x, float y, float& x0, float& y0,
    float (&xs)[kUndistortIters + 1], float (&ys)[kUndistortIters + 1]) {
  const float ox = x * c.m[0] + y * c.m[1] + c.m[2];
  const float oy = x * c.m[3] + y * c.m[4] + c.m[5];
  x0 = (ox - c.cx) / c.fx;
  y0 = (oy - c.cy) / c.fy;
  xs[0] = x0;
  ys[0] = y0;
#pragma unroll
  for (int it = 0; it < kUndistortIters; ++it) {
    const float xu = xs[it], yu = ys[it];
    const float r2 = xu * xu + yu * yu;
    const float icdist =
        1.0f / (1.0f + ((c.k3 * r2 + c.k2) * r2 + c.k1) * r2);
    const float dx = 2.0f * c.p1 * xu * yu + c.p2 * (r2 + 2.0f * xu * xu);
    const float dy = c.p1 * (r2 + 2.0f * yu * yu) + 2.0f * c.p2 * xu * yu;
    xs[it + 1] = (x0 - dx) * icdist;
    ys[it + 1] = (y0 - dy) * icdist;
  }
}

// The VJP of undistort_iterates and of the pixel fx * x + cx: the
// cotangent (gux, guy) of the undistorted pixel back to the net point,
// (gx_out, gy_out).
__device__ __forceinline__ void undistort_bwd(
    const View& c, float x0, float y0,
    const float (&xs)[kUndistortIters + 1],
    const float (&ys)[kUndistortIters + 1], float gux, float guy,
    float& gx_out, float& gy_out) {
  float gx = gux * c.fx, gy = guy * c.fy;
  float gx0 = 0.0f, gy0 = 0.0f;
#pragma unroll
  for (int it = kUndistortIters - 1; it >= 0; --it) {
    const float xu = xs[it], yu = ys[it];
    const float r2 = xu * xu + yu * yu;
    const float h1 = c.k3 * r2 + c.k2;
    const float h2 = h1 * r2 + c.k1;
    const float icdist = 1.0f / (1.0f + h2 * r2);
    const float dx = 2.0f * c.p1 * xu * yu + c.p2 * (r2 + 2.0f * xu * xu);
    const float dy = c.p1 * (r2 + 2.0f * yu * yu) + 2.0f * c.p2 * xu * yu;
    // x' = (x0 - dx) * icdist
    const float gnx = gx * icdist, gny = gy * icdist;
    const float gic = gx * (x0 - dx) + gy * (y0 - dy);
    gx0 = gx0 + gnx;
    gy0 = gy0 + gny;
    // icdist = 1 / den, torch's reciprocal: -g * icdist^2
    const float gden = -gic * (icdist * icdist);
    const float gh2 = gden * r2;
    const float gh1 = gh2 * r2;
    float gr2 = gden * h2 + gh2 * h1 + gh1 * c.k3;
    // dx = (2 p1 x) y + p2 (r2 + (2 x) x); dy = p1 (r2 + (2 y) y) + (2 p2 x) y
    const float gdx = -gnx, gdy = -gny;
    const float tx = gdx * c.p2, ty = gdy * c.p1;
    gr2 = gr2 + tx + ty;
    const float gxi = gdx * yu * (2.0f * c.p1) + tx * xu * 2.0f +
                      tx * (2.0f * xu) + gdy * yu * (2.0f * c.p2);
    const float gyi = gdx * (2.0f * c.p1 * xu) + ty * yu * 2.0f +
                      ty * (2.0f * yu) + gdy * (2.0f * c.p2 * xu);
    // r2 = x x + y y
    gx = gxi + gr2 * xu + gr2 * xu;
    gy = gyi + gr2 * yu + gr2 * yu;
  }
  // iteration 0 reads (x0, y0) as its (x, y)
  gx0 = gx0 + gx;
  gy0 = gy0 + gy;
  // x0 = (ox - cx) / fx; the affine's transpose
  const float gox = gx0 / c.fx, goy = gy0 / c.fy;
  gx_out = gox * c.m[0] + goy * c.m[3];
  gy_out = gox * c.m[1] + goy * c.m[4];
}

// torch.sign: 0 for 0 and NaN
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// The VJP of rotate<P, Q>: a and v hold the state before the rotation;
// da and dv enter as the cotangents of the state after it and leave as
// those of the state before it. The forward's scalars are recomputed from
// a, and each term follows torch's derivative of the op in
// jacobi4_smallest: torch.where passes nothing to the branch it did not
// take (small, tau == 0), abs and sign as torch defines them at 0.
template <int P, int Q>
__device__ __forceinline__ void rotate_bwd(const float (&a)[4][4],
                                           const float (&v)[4][4],
                                           float (&da)[4][4],
                                           float (&dv)[4][4]) {
  const float app = a[P][P], aqq = a[Q][Q], apq = a[P][Q];
  const bool small =
      fabsf(apq) <= 1e-12f * (fabsf(app) + fabsf(aqq)) + 1e-15f;
  const float safe = small ? 1.0f : apq;
  const float num = aqq - app, den = 2.0f * safe;
  const float tau = num / den;
  const float sgn = sign_of(tau);
  const float root = sqrtf(1.0f + tau * tau);
  const float dd = fabsf(tau) + root;
  float t = sgn / dd;
  if (tau == 0.0f) t = 1.0f;
  if (small) t = 0.0f;
  const float q = sqrtf(1.0f + t * t);
  const float c = 1.0f / q;
  const float s = t * c;
  // the rotated rows: x' = c x_p - s x_q, y' = s x_p + c x_q
  float gc = 0.0f, gs = 0.0f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (r == P || r == Q) continue;
    const float arp = r < P ? a[r][P] : a[P][r];
    const float arq = r < Q ? a[r][Q] : a[Q][r];
    float& grp = r < P ? da[r][P] : da[P][r];
    float& grq = r < Q ? da[r][Q] : da[Q][r];
    const float gp = grp, gq = grq;
    gc = gc + gp * arp + gq * arq;
    gs = gs - gp * arq + gq * arp;
    grp = c * gp + s * gq;
    grq = c * gq - s * gp;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float vrp = v[r][P], vrq = v[r][Q];
    const float gp = dv[r][P], gq = dv[r][Q];
    gc = gc + gp * vrp + gq * vrq;
    gs = gs - gp * vrq + gq * vrp;
    dv[r][P] = c * gp + s * gq;
    dv[r][Q] = c * gq - s * gp;
  }
  // app' = app - t apq, aqq' = aqq + t apq, apq' = small ? apq : 0
  const float gpp = da[P][P], gqq = da[Q][Q], gpq = da[P][Q];
  float gt = gqq * apq - gpp * apq;
  float gapq = gqq * t - gpp * t + (small ? gpq : 0.0f);
  // s = t c; c = 1 / sqrt(u), u = 1 + t t
  gt = gt + gs * c;
  gc = gc + gs * t;
  const float gu = (-gc * (c * c)) / (2.0f * q);
  gt = gt + gu * t + gu * t;
  // t = where(small, 0, where(tau == 0, 1, sgn / dd))
  const float gt0 = (small || tau == 0.0f) ? 0.0f : gt;
  // dd = |tau| + sqrt(w), w = 1 + tau tau; sign(tau) has no derivative
  const float gdd = -gt0 * ((sgn / dd) / dd);
  const float gw = gdd / (2.0f * root);
  const float gtau = gdd * sgn + gw * tau + gw * tau;
  // tau = num / den, num = aqq - app, den = 2 safe, safe = small ? 1 : apq
  const float gnum = gtau / den;
  const float gden = -gtau * ((num / den) / den);
  if (!small) gapq = gapq + gden * 2.0f;
  da[P][P] = gpp - gnum;
  da[Q][Q] = gqq + gnum;
  da[P][Q] = gapq;
}

__device__ __forceinline__ void save_state(float* ck, const float (&a)[4][4],
                                           const float (&v)[4][4]) {
  int k = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = r; j < 4; ++j) ck[k++] = a[r][j];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) ck[k++] = v[r][j];
}

__device__ __forceinline__ void load_state(const float* ck, float (&a)[4][4],
                                           float (&v)[4][4]) {
  int k = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = r; j < 4; ++j) a[r][j] = ck[k++];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) v[r][j] = ck[k++];
}

// the first J rotations of a sweep, forward
template <int J>
__device__ __forceinline__ void replay(float (&a)[4][4], float (&v)[4][4]) {
  if constexpr (J > 0) {
    replay<J - 1>(a, v);
    rotate<kPairP[J - 1], kPairQ[J - 1]>(a, v);
  }
}

// Rotations J, J - 1, ..., 0 of a sweep in reverse. The state before
// rotation j is replayed from the sweep's first state, `ck`, so that no
// rotation's state is kept.
template <int J>
__device__ __forceinline__ void sweep_bwd(const float* ck, float (&da)[4][4],
                                          float (&dv)[4][4]) {
  float a[4][4], v[4][4];
  load_state(ck, a, v);
  replay<J>(a, v);
  rotate_bwd<kPairP[J], kPairQ[J]>(a, v, da, dv);
  if constexpr (J > 0) sweep_bwd<J - 1>(ck, da, dv);
}

// Row r of view v's two system rows (pm its projection): e = P[2] u -
// P[r], A = e w and An = A / cs as (4) and (5) compute them; and the
// row's cotangent d(An) = An dG^T + An dG for the cotangent dG of the
// Gram matrix's upper half (jacobi4_smallest reads nothing below it).
__device__ __forceinline__ void row_bwd(const float* pm, float u, int r,
                                        float w, const float (&cs)[4],
                                        const float (&dg)[4][4],
                                        float (&e)[4], float (&A)[4],
                                        float (&an)[4], float (&dan)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    e[j] = dlt_entry(pm, u, r, j);
    A[j] = e[j] * w;
    an[j] = A[j] / cs[j];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float left = 0.0f, right = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      left = left + an[j] * (k <= j ? dg[k][j] : 0.0f);
      right = right + an[j] * (j <= k ? dg[j][k] : 0.0f);
    }
    dan[k] = left + right;
  }
}

__device__ __forceinline__ void write_zero_grads(const BwdArgs& g,
                                                 int64_t i) {
  const int64_t points = (int64_t)g.f.B * g.f.N;
#pragma unroll
  for (int v = 0; v < kMaxViews; ++v) {
    if (v >= g.f.V) break;
    g.d_refined[2 * (v * points + i)] = 0.0f;
    g.d_refined[2 * (v * points + i) + 1] = 0.0f;
    g.d_logits[v * points + i] = 0.0f;
  }
}

// torch's clip of a cotangent of norm n (TRI_GRAD_CLIP, _ClipCotangent):
// the factor min(max_norm / max(n, 1e-30), 1), NaN kept
__device__ __forceinline__ float clip_scale(float n, float max_norm) {
  const float least = n < 1e-30f ? 1e-30f : n;
  const float ratio = (1.0f / least) * max_norm;
  return ratio > 1.0f ? 1.0f : ratio;
}

__global__ void __launch_bounds__(kThreads)
    dlt_jacobi_bwd_kernel(const BwdArgs g) {
  const Args& f = g.f;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (int64_t)f.B * f.N) return;
  const int b = (int)(i / f.N);
  const int n = (int)(i - (int64_t)b * f.N);
  const int64_t points = (int64_t)f.B * f.N;
  // a masked-out point's output is a constant zero: no cotangent
  if (!f.mask[i]) {
    write_zero_grads(g, i);
    return;
  }

  // the forward again, from the inputs: (1)-(2) per view, (3) the softmax
  float ux[kMaxViews], uy[kMaxViews], w[kMaxViews];
#pragma unroll
  for (int v = 0; v < kMaxViews; ++v) {
    if (v >= f.V) break;
    const View cam = load_view(f, b * f.V + v);
    const float* pt = f.refined + v * f.rs_v + b * f.rs_b + n * f.rs_n;
    float x0, y0, xs[kUndistortIters + 1], ys[kUndistortIters + 1];
    undistort_iterates(cam, pt[0], pt[f.rs_c], x0, y0, xs, ys);
    ux[v] = cam.fx * xs[kUndistortIters] + cam.cx;
    uy[v] = cam.fy * ys[kUndistortIters] + cam.cy;
    w[v] = f.logits[v * f.ls_v + b * f.ls_b + n * f.ls_n];
  }
  float lmax = w[0];
#pragma unroll
  for (int v = 1; v < kMaxViews; ++v)
    if (v < f.V) lmax = fmaxf(lmax, w[v]);
  float sum = 0.0f;
#pragma unroll
  for (int v = 0; v < kMaxViews; ++v) {
    if (v >= f.V) break;
    w[v] = expf(w[v] - lmax);
    sum += w[v];
  }
#pragma unroll
  for (int v = 0; v < kMaxViews; ++v)
    if (v < f.V) w[v] = w[v] / sum;

  // (4) the column maxima; a degenerate system's rows are constants
  const float* pm_b = f.proj + (int64_t)12 * b * f.V;
  float amax[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int v = 0; v < kMaxViews; ++v) {
    if (v >= f.V) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float u = r == 0 ? ux[v] : uy[v];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        amax[j] = nan_max(amax[j],
                          fabsf(dlt_entry(pm_b + 12 * v, u, r, j) * w[v]));
    }
  }
  if (nan_max(nan_max(amax[0], amax[1]), nan_max(amax[2], amax[3])) <
      1e-10f) {
    write_zero_grads(g, i);
    return;
  }
  float cs[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) cs[j] = amax[j] + 1e-12f;

  // (5) the Gram matrix
  float a[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[r][j] = 0.0f;
#pragma unroll
  for (int v = 0; v < kMaxViews; ++v) {
    if (v >= f.V) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float u = r == 0 ? ux[v] : uy[v];
      float an[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        an[j] = dlt_entry(pm_b + 12 * v, u, r, j) * w[v] / cs[j];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int j = ii; j < 4; ++j) a[ii][j] = a[ii][j] + an[ii] * an[j];
    }
  }

  // (6) the sweeps, each one's first state kept
  float rot[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) rot[r][j] = r == j ? 1.0f : 0.0f;
  float ck[kSweeps][kState];
#pragma unroll 1
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    save_state(ck[sweep], a, rot);
    rotate<0, 1>(a, rot);
    rotate<0, 2>(a, rot);
    rotate<0, 3>(a, rot);
    rotate<1, 2>(a, rot);
    rotate<1, 3>(a, rot);
    rotate<2, 3>(a, rot);
  }

  // (7) the argmin, its eigenvector x = rot[:, best] / cs
  int best = 0;
  float low = a[0][0];
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    const float d = a[j][j];
    if (!isnan(low) && (d < low || isnan(d))) {
      low = d;
      best = j;
    }
  }
  float x[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    x[r] = rot[r][0];
#pragma unroll
    for (int j = 1; j < 4; ++j)
      if (best == j) x[r] = rot[r][j];
    x[r] = x[r] / cs[r];
  }

  // the reverse of (7): out = x[:3] / x[3], x = rot[:, best] / cs
  const float* go = g.grad + b * g.gs_b + n * g.gs_n;
  float gx[4];
  gx[3] = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float gk = go[k * g.gs_c];
    gx[k] = gk / x[3];
    gx[3] = gx[3] - gk * ((x[k] / x[3]) / x[3]);
  }
  float da[4][4], dv[4][4], dcs[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    dcs[r] = -gx[r] * (x[r] / cs[r]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      da[r][j] = 0.0f;  // the argmin passes no cotangent to the diagonal
      dv[r][j] = best == j ? gx[r] / cs[r] : 0.0f;
    }
  }

  // the reverse of (6), sweep by sweep
#pragma unroll 1
  for (int sweep = kSweeps - 1; sweep >= 0; --sweep)
    sweep_bwd<kPairs - 1>(ck[sweep], da, dv);

  // the reverse of (5) and (4): a first pass over the rows gathers the
  // column scales' cotangent and the ties of their maxima, a second sends
  // both with the Gram matrix's to each row, then to the undistorted
  // points and the weights
  float ties[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int v = 0; v < kMaxViews; ++v) {
    if (v >= f.V) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float e[4], A[4], an[4], dan[4];
      row_bwd(pm_b + 12 * v, r == 0 ? ux[v] : uy[v], r, w[v], cs, da, e, A,
              an, dan);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // An = A / cs: -g (A / cs) / cs to the scale
        dcs[k] = dcs[k] - dan[k] * (an[k] / cs[k]);
        if (fabsf(A[k]) == amax[k]) ties[k] = ties[k] + 1.0f;
      }
    }
  }
  float gux[kMaxViews], guy[kMaxViews], gw[kMaxViews];
#pragma unroll
  for (int v = 0; v < kMaxViews; ++v) {
    if (v >= f.V) break;
    const float* pm = pm_b + 12 * v;
    gw[v] = 0.0f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float e[4], A[4], an[4], dan[4];
      row_bwd(pm, r == 0 ? ux[v] : uy[v], r, w[v], cs, da, e, A, an, dan);
      float gu = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // amax: the cotangent split among the ties; abs: times sgn(A)
        const float at_max = fabsf(A[k]) == amax[k] ? 1.0f : 0.0f;
        const float gA =
            dan[k] / cs[k] + (dcs[k] / ties[k]) * at_max * sign_of(A[k]);
        // A = e w, e = P[2][k] u - P[r][k]
        gw[v] = gw[v] + gA * e[k];
        gu = gu + (gA * w[v]) * __ldg(pm + 8 + k);
      }
      if (r == 0)
        gux[v] = gu;
      else
        guy[v] = gu;
    }
    if (g.clip) {
      const float sp = clip_scale(sqrtf(gux[v] * gux[v] + guy[v] * guy[v]),
                                  g.max_norm);
      gux[v] = gux[v] * sp;
      guy[v] = guy[v] * sp;
      gw[v] = gw[v] * clip_scale(sqrtf(gw[v] * gw[v]), g.max_norm);
    }
  }
  // the softmax's reverse: w (gw - sum gw w)
  float dot = 0.0f;
#pragma unroll
  for (int v = 0; v < kMaxViews; ++v)
    if (v < f.V) dot = dot + gw[v] * w[v];

  // (1)-(2)'s reverse per view, and the writes
#pragma unroll
  for (int v = 0; v < kMaxViews; ++v) {
    if (v >= f.V) break;
    const View cam = load_view(f, b * f.V + v);
    const float* pt = f.refined + v * f.rs_v + b * f.rs_b + n * f.rs_n;
    float x0, y0, xs[kUndistortIters + 1], ys[kUndistortIters + 1];
    undistort_iterates(cam, pt[0], pt[f.rs_c], x0, y0, xs, ys);
    float grx, gry;
    undistort_bwd(cam, x0, y0, xs, ys, gux[v], guy[v], grx, gry);
    g.d_refined[2 * (v * points + i)] = grx;
    g.d_refined[2 * (v * points + i) + 1] = gry;
    g.d_logits[v * points + i] = w[v] * (gw[v] - dot);
  }
}

}  // namespace

// C interface, bound with ctypes. refined (V, B, N, 2) and logits (V, B, N)
// are float32 at the element strides given; mask (B, N) bool, inv_affine
// (B, V, 2, 3), f, c (B, V, 2), k (B, V, 3), p (B, V, 2), proj (B, V, 3, 4)
// float32 and contiguous; out (B, N, 3) float32, written whole. Launches
// on `stream`, synchronizes nothing, allocates nothing. Returns the
// cudaError_t of the launch; -1 for arguments the kernel does not take.
extern "C" int mvg_dlt_jacobi(const void* refined, int64_t rs_v,
                              int64_t rs_b, int64_t rs_n, int64_t rs_c,
                              const void* logits, int64_t ls_v, int64_t ls_b,
                              int64_t ls_n, const void* mask,
                              const void* inv_affine, const void* f,
                              const void* c, const void* k, const void* p,
                              const void* proj, void* out, int B, int N,
                              int V, void* stream) {
  if (B < 1 || N < 1 || V < 1 || V > kMaxViews) return -1;
  const Args g{static_cast<const float*>(refined),
               rs_v, rs_b, rs_n, rs_c,
               static_cast<const float*>(logits),
               ls_v, ls_b, ls_n,
               static_cast<const bool*>(mask),
               static_cast<const float*>(inv_affine),
               static_cast<const float*>(f),
               static_cast<const float*>(c),
               static_cast<const float*>(k),
               static_cast<const float*>(p),
               static_cast<const float*>(proj),
               static_cast<float*>(out),
               B, N, V};
  const int64_t points = (int64_t)B * N;
  const unsigned blocks = (unsigned)((points + kThreads - 1) / kThreads);
  dlt_jacobi_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}

// C interface of the backward, bound with ctypes. The forward's operands
// as mvg_dlt_jacobi takes them; grad (B, N, 3) float32 at the element
// strides given, the cotangent of out; d_refined (V, B, N, 2) and
// d_logits (V, B, N) float32 and contiguous, written whole; clip != 0
// clips each view's point and weight cotangent to norm max_norm.
// Launches on `stream`, synchronizes nothing, allocates nothing. Returns
// the cudaError_t of the launch; -1 for arguments the kernel does not
// take.
extern "C" int mvg_dlt_jacobi_bwd(
    const void* refined, int64_t rs_v, int64_t rs_b, int64_t rs_n,
    int64_t rs_c, const void* logits, int64_t ls_v, int64_t ls_b,
    int64_t ls_n, const void* mask, const void* inv_affine, const void* f,
    const void* c, const void* k, const void* p, const void* proj,
    const void* grad, int64_t gs_b, int64_t gs_n, int64_t gs_c,
    void* d_refined, void* d_logits, float max_norm, int clip, int B, int N,
    int V, void* stream) {
  if (B < 1 || N < 1 || V < 1 || V > kMaxViews) return -1;
  const BwdArgs g{{static_cast<const float*>(refined), rs_v, rs_b, rs_n,
                   rs_c, static_cast<const float*>(logits), ls_v, ls_b,
                   ls_n, static_cast<const bool*>(mask),
                   static_cast<const float*>(inv_affine),
                   static_cast<const float*>(f),
                   static_cast<const float*>(c),
                   static_cast<const float*>(k),
                   static_cast<const float*>(p),
                   static_cast<const float*>(proj), nullptr, B, N, V},
                  static_cast<const float*>(grad),
                  gs_b, gs_n, gs_c,
                  static_cast<float*>(d_refined),
                  static_cast<float*>(d_logits),
                  max_norm, clip};
  const int64_t points = (int64_t)B * N;
  const unsigned blocks = (unsigned)((points + kThreads - 1) / kThreads);
  dlt_jacobi_bwd_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}
