// Windowed layer-1 sampling straight from the padded feature map, forward,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel mvgformer_tpu/ops/window_dma.py::_kernel (wrapper
// window_block_dma). Row r of block b = r / block_rows reads the (K, Kx)
// window of padded_map[v] at (y0, x0), with (v, y0, x0) = origins[b]:
//
//   out[r, h*D:(h+1)*D] = sum_{gy < K, gx < Kx} rw[gy, gx] * win[gy, gx, h*D:(h+1)*D]
//   rw = sum_p aw_p * relu(1 - |ry_p - gy|) * relu(1 - |rx_p - gx|)
//
// where rel[r] packs, per head, [ry(P) | rx(P) | aw(P)] in window pixels.
// The TPU kernel copies the window into VMEM with a DMA, builds the
// K*Kx-wide row rw and multiplies it into the window on the MXU. The tent
// weights are non-zero only at gy in {floor(ry), floor(ry) + 1} and gx in
// {floor(rx), floor(rx) + 1}, so here the sum is exactly a bilinear read of
// at most four window pixels per point, read in place from the map, each
// kept only if it lies inside the window. No weight row and no window copy
// is made. x0 is the plain pixel origin (the TPU kernel's x0 / 8 exists only
// for its compiler's alignment proof); the caller aligns x0 down to a
// multiple of 8 and widens the window to Kx, and rx is relative to that
// aligned origin.
//
// What bounds it on this card: reads of the window pixels, four 64-byte
// corners per point in bfloat16 at D = 32, from a padded map that at the
// flagship's finest level is 5 x 160 x 276 x 256 x 2 B ~= 113 MB per frame.
// Arithmetic is negligible. The rows of a block share one window, and the
// windows of neighbouring blocks overlap, so most corners are L2 hits.
//
// Layout, as window_block.cu's: one thread per 16-byte vector of the
// output, threads ordered (row, head, vector), so at D = 32 bf16 a warp
// makes one row's 8 heads and a block of 256 threads 8 consecutive rows of
// one or two windows. A thread reads its (row, head)'s rel as vectors and
// issues the corner loads of a batch of points (predicated,
// vec16.cuh::bilinear_batch over the window at the map's strides) before
// their multiply-adds (see kBatch). Instances: P = 4 or 8 known at compile
// time, and any P at run time. When D * esize is no multiple of 16 bytes or
// a pointer is not 16-byte aligned the wrapper launches the generic
// instance: the same kernel with one element per thread and scalar loads.
// A window that does not lie inside the map reads nothing and gives zero
// rows. Sums are float32, per output element in the order points ->
// corners.

#include <cuda_runtime.h>
#include <stdint.h>

#include "vec16.cuh"

namespace {

using namespace mvg_vec;

constexpr int kThreads = 256;
// points per batch of corner loads: 4 * kBatch loads in flight per thread,
// batch after batch in a loop the compiler keeps rolled (as window_block.cu:
// a straight-line batch of 4 points there took 142 registers and ran at
// less than half the speed of batches of 2).
constexpr int kBatch = 2;

// V elements per thread (kVec<T>, or 1 for the generic instance); kP the
// points when known at compile time, else 0.
template <typename T, int V, int kP>
__global__ void __launch_bounds__(kThreads)
window_dma_fwd_kernel(const T* __restrict__ pmap,
                      const float* __restrict__ rel,
                      const int* __restrict__ origins, T* __restrict__ out,
                      int n_views, int hp, int wp, int nrows, int K, int Kx,
                      int H, int P_, int D, int block_rows) {
  constexpr int kB = kP > 0 && kP < kBatch ? kP : kBatch;
  const int P = kP > 0 ? kP : P_;
  const int vpr = D / V;  // threads per (row, head)
  // the launcher keeps nrows * H * vpr below 2^31
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= nrows * H * vpr) return;
  const int rh = t / vpr;
  const int j = t - rh * vpr;
  const int h = rh % H;
  const int r = rh / H;
  const int64_t hd = (int64_t)H * D;
  const int* o = origins + 3 * (r / block_rows);
  const int v = o[0], y0 = o[1], x0 = o[2];
  // a window that does not lie inside the map reads nothing; the caller's
  // plan never makes one
  const bool win_ok = v >= 0 && v < n_views && y0 >= 0 && y0 <= hp - K &&
                      x0 >= 0 && x0 <= wp - Kx;
  const float* rel_t = rel + (int64_t)rh * 3 * P;  // [ry(P) | rx(P) | aw(P)]
  const T* win =
      pmap + (win_ok ? (((int64_t)v * hp + y0) * wp + x0) * hd : 0) +
      h * D + j * V;

  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
#pragma unroll 1
  for (int p0 = 0; p0 < P; p0 += kB) {
    float y[kB], x[kB], a[kB];
    const int have = win_ok ? (kP > 0 ? kB : min(kB, P - p0)) : 0;
    if constexpr (kP > 0) {
      load_n<float, kB>(rel_t + p0, y);
      load_n<float, kB>(rel_t + kP + p0, x);
      load_n<float, kB>(rel_t + 2 * kP + p0, a);
    } else {
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const int p = p0 + (p0 + b < P ? b : 0);
        y[b] = rel_t[p];
        x[b] = rel_t[P + p];
        a[b] = rel_t[2 * P + p];
      }
    }
    bilinear_batch<T, V, kB>(acc, y, x, a, have, win, (int64_t)wp * hd, hd,
                             K, Kx);
  }
  store<T, V>(out + (int64_t)r * hd + h * D + j * V, acc);
}

template <typename T, int V, int kP>
int launch_one(const void* pmap, const float* rel, const int* origins,
               void* out, int n_views, int hp, int wp, int nrows, int K,
               int Kx, int H, int P, int D, int block_rows,
               cudaStream_t stream) {
  const int64_t threads = (int64_t)nrows * H * (D / V);
  if (threads > INT32_MAX - kThreads) return -1;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks == 0) return (int)cudaSuccess;
  window_dma_fwd_kernel<T, V, kP><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(pmap), rel, origins, static_cast<T*>(out),
      n_views, hp, wp, nrows, K, Kx, H, P, D, block_rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* pmap, const float* rel, const int* origins, void* out,
           int n_views, int hp, int wp, int nrows, int K, int Kx, int H,
           int P, int D, int block_rows, int vec, cudaStream_t stream) {
  constexpr int kV = kVec<T>;
  if (vec == 1)
    return launch_one<T, 1, 0>(pmap, rel, origins, out, n_views, hp, wp,
                               nrows, K, Kx, H, P, D, block_rows, stream);
  if (vec != kV || D % kV != 0) return -1;
  if (P == 4)
    return launch_one<T, kV, 4>(pmap, rel, origins, out, n_views, hp, wp,
                                nrows, K, Kx, H, P, D, block_rows, stream);
  if (P == 8)
    return launch_one<T, kV, 8>(pmap, rel, origins, out, n_views, hp, wp,
                                nrows, K, Kx, H, P, D, block_rows, stream);
  return launch_one<T, kV, 0>(pmap, rel, origins, out, n_views, hp, wp,
                              nrows, K, Kx, H, P, D, block_rows, stream);
}

}  // namespace

// C interface, bound with ctypes. padded_map (V, hp, wp, H*D), rel
// (nrows, H*3P) float32, origins (nrows / block_rows, 3) int32 rows of
// (view, y0, x0) in padded pixels, out (nrows, H*D). dtype: 0 = float32,
// 1 = bfloat16 (padded_map and out share it). vec: elements per thread,
// 16 / esize (padded_map, rel and out 16-byte aligned, D * esize a multiple
// of 16) or 1 (the generic instance). Returns the cudaError_t of the
// launch; -1 for arguments the kernel does not take.
extern "C" int mvg_window_dma_forward(const void* pmap, const void* rel,
                                      const void* origins, void* out, int V,
                                      int hp, int wp, int nrows, int K,
                                      int Kx, int H, int P, int D,
                                      int block_rows, int dtype, int vec,
                                      void* stream) {
  if (K < 1 || Kx < K || H < 1 || P < 1 || D < 1 || block_rows < 1 ||
      nrows % block_rows != 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* relf = static_cast<const float*>(rel);
  const int* og = static_cast<const int*>(origins);
  if (dtype == 0)
    return launch<float>(pmap, relf, og, out, V, hp, wp, nrows, K, Kx, H, P,
                         D, block_rows, vec, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(pmap, relf, og, out, V, hp, wp, nrows, K,
                                 Kx, H, P, D, block_rows, vec, s);
  return -1;
}
