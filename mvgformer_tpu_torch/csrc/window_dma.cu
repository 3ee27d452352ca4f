// Windowed layer-1 sampling straight from the padded feature map, forward,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel mvgformer_tpu/ops/window_dma.py::_kernel (wrapper
// window_block_dma). Row r of block b = r / block_rows reads the (K, Kx)
// window of padded_map[v] at (y0, x0), with (v, y0, x0) = origins[b]; the
// math is in window_common.cuh. The TPU kernel copies that window into VMEM
// with a DMA; here the window pixels are read in place, so no tile buffer
// is made. x0 is the plain pixel origin (the TPU kernel's x0 / 8 exists
// only for its compiler's alignment proof); the caller aligns x0 down to a
// multiple of 8 and widens the window to Kx, and rx is relative to that
// aligned origin.
//
// What bounds it on this card: reads of the window pixels, four 64-byte
// corners per point in bfloat16 at D = 32, from a padded map that at the
// flagship's finest level is 5 x 160 x 276 x 256 x 2 B ~= 113 MB per frame
// (twice L2's 50 MB). Arithmetic is negligible. Staging a window in shared memory is
// later work; the whole (K, Kx, H*D) bfloat16 window is ~459 KB at K = 28,
// twice an SM's 228 KB, so staging would go per head (~57 KB).
//
// Layout (simple, correct first): one warp per (row, head), lanes over D;
// sums are float32.

#include <cuda_runtime.h>

#include "window_common.cuh"

namespace {

using namespace mvg_window;

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
window_dma_fwd_kernel(const T* __restrict__ pmap,
                      const float* __restrict__ rel,
                      const int* __restrict__ origins, T* __restrict__ out,
                      int V, int hp, int wp, int nrows, int K, int Kx, int H,
                      int P, int D, int block_rows) {
  const int64_t warp =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= (int64_t)nrows * H) return;
  const int h = (int)(warp % H);
  const int64_t r = warp / H;
  const int64_t hd = (int64_t)H * D;
  const int* o = origins + 3 * (r / block_rows);
  const int v = o[0], y0 = o[1], x0 = o[2];
  // a window that does not lie inside the map reads nothing; the caller's
  // plan never makes one
  const bool win_ok = v >= 0 && v < V && y0 >= 0 && y0 + K <= hp &&
                      x0 >= 0 && x0 + Kx <= wp;
  const float* rel_h = rel + (r * H + h) * 3 * P;
  const T* win =
      pmap + (win_ok ? (((int64_t)v * hp + y0) * wp + x0) * hd : 0) + h * D;
  for (int d = lane; d < D; d += 32) {
    const float acc =
        win_ok ? window_point_sum(rel_h, P, win + d, (int64_t)wp * hd, hd, K,
                                  Kx)
               : 0.f;
    store_f(out + r * hd + h * D + d, acc);
  }
}

template <typename T>
int launch(const void* pmap, const float* rel, const int* origins, void* out,
           int V, int hp, int wp, int nrows, int K, int Kx, int H, int P,
           int D, int block_rows, cudaStream_t stream) {
  const int64_t warps = (int64_t)nrows * H;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks == 0) return (int)cudaSuccess;
  window_dma_fwd_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                             stream>>>(
      static_cast<const T*>(pmap), rel, origins, static_cast<T*>(out), V, hp,
      wp, nrows, K, Kx, H, P, D, block_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes. padded_map (V, hp, wp, H*D), rel
// (nrows, H*3P) float32, origins (nrows / block_rows, 3) int32 rows of
// (view, y0, x0) in padded pixels, out (nrows, H*D). dtype: 0 = float32,
// 1 = bfloat16 (padded_map and out share it). Returns the cudaError_t of
// the launch; -1 for arguments the kernel does not take.
extern "C" int mvg_window_dma_forward(const void* pmap, const void* rel,
                                      const void* origins, void* out, int V,
                                      int hp, int wp, int nrows, int K,
                                      int Kx, int H, int P, int D,
                                      int block_rows, int dtype,
                                      void* stream) {
  if (K < 1 || Kx < K || H < 1 || P < 1 || D < 1 || block_rows < 1 ||
      nrows % block_rows != 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* relf = static_cast<const float*>(rel);
  const int* og = static_cast<const int*>(origins);
  if (dtype == 0)
    return launch<float>(pmap, relf, og, out, V, hp, wp, nrows, K, Kx, H, P,
                         D, block_rows, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(pmap, relf, og, out, V, hp, wp, nrows, K,
                                 Kx, H, P, D, block_rows, s);
  return -1;
}
