// Windowed layer-1 sampling over pre-cut tile windows, forward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel mvgformer_tpu/ops/window_pallas.py::_kernel
// (wrapper window_block_matmul). Row r of block b = r / block_rows reads
// the window tiles[block_tile[b]], shaped (K*K, H*D); the math is in
// window_common.cuh.
//
// What bounds it on this card: reads of the window pixels. The tile buffer
// (n_tiles, K*K, H*D) is made by the caller; at the flagship's finest level
// and K = 28 it is ~1 GB in bfloat16 per frame, far beyond L2 (50 MB), and
// each point reads four 64-byte corners of it. Arithmetic is negligible.
//
// Layout (simple, correct first): one warp per (row, head), lanes over D,
// so one corner is one coalesced read of D contiguous elements (64 bytes in
// bfloat16 at D = 32). The rel values are the same for every lane of the
// warp (a broadcast load), so every branch is uniform across the warp.
// Sums are float32.

#include <cuda_runtime.h>

#include "window_common.cuh"

namespace {

using namespace mvg_window;

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
window_block_fwd_kernel(const T* __restrict__ tiles,
                        const float* __restrict__ rel,
                        const int* __restrict__ block_tile,
                        T* __restrict__ out, int n_tiles, int nrows, int K,
                        int H, int P, int D, int block_rows) {
  const int64_t warp =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= (int64_t)nrows * H) return;
  const int h = (int)(warp % H);
  const int64_t r = warp / H;
  const int64_t hd = (int64_t)H * D;
  const int t = block_tile[r / block_rows];
  // a tile id outside the buffer reads nothing; the caller's plan never
  // makes one
  const bool tile_ok = t >= 0 && t < n_tiles;
  const float* rel_h = rel + (r * H + h) * 3 * P;
  const T* win = tiles + (tile_ok ? (int64_t)t * K * K * hd : 0) + h * D;
  for (int d = lane; d < D; d += 32) {
    const float acc =
        tile_ok ? window_point_sum(rel_h, P, win + d, K * hd, hd, K, K) : 0.f;
    store_f(out + r * hd + h * D + d, acc);
  }
}

template <typename T>
int launch(const void* tiles, const float* rel, const int* block_tile,
           void* out, int n_tiles, int nrows, int K, int H, int P, int D,
           int block_rows, cudaStream_t stream) {
  const int64_t warps = (int64_t)nrows * H;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks == 0) return (int)cudaSuccess;
  window_block_fwd_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                               stream>>>(
      static_cast<const T*>(tiles), rel, block_tile, static_cast<T*>(out),
      n_tiles, nrows, K, H, P, D, block_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes. tiles (n_tiles, K*K, H*D), rel
// (nrows, H*3P) float32, block_tile (nrows / block_rows,) int32, out
// (nrows, H*D). dtype: 0 = float32, 1 = bfloat16 (tiles and out share it).
// Returns the cudaError_t of the launch; -1 for arguments the kernel does
// not take.
extern "C" int mvg_window_block_forward(const void* tiles, const void* rel,
                                        const void* block_tile, void* out,
                                        int n_tiles, int nrows, int K, int H,
                                        int P, int D, int block_rows,
                                        int dtype, void* stream) {
  if (K < 1 || H < 1 || P < 1 || D < 1 || block_rows < 1 ||
      nrows % block_rows != 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* relf = static_cast<const float*>(rel);
  const int* bt = static_cast<const int*>(block_tile);
  if (dtype == 0)
    return launch<float>(tiles, relf, bt, out, n_tiles, nrows, K, H, P, D,
                         block_rows, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(tiles, relf, bt, out, n_tiles, nrows, K, H,
                                 P, D, block_rows, s);
  return -1;
}
