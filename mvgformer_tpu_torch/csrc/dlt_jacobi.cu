// The serving Jacobi DLT, forward, for Hopper (sm_90a): steps 8-9 of a DQ
// decoder layer (mvgformer_tpu_torch/models/decoder.py) in one launch.
//
// Replaces, for a serving call (no gradient, every view on this process),
// the plain chain from the refined 2D points to the masked 3D points:
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
