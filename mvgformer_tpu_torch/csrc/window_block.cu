// Windowed layer-1 sampling over pre-cut tile windows, forward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel mvgformer_tpu/ops/window_pallas.py::_kernel
// (wrapper window_block_matmul). Row r of block b = r / block_rows reads
// the window tiles[block_tile[b]], shaped (K*K, H*D):
//
//   out[r, h*D:(h+1)*D] = sum_{gy, gx < K} rw[gy, gx] * win[gy, gx, h*D:(h+1)*D]
//   rw = sum_p aw_p * relu(1 - |ry_p - gy|) * relu(1 - |rx_p - gx|)
//
// where rel[r] packs, per head, [ry(P) | rx(P) | aw(P)] in window pixels.
// The TPU kernel builds the K*K-wide row rw and multiplies it into the
// window on the MXU. The tent weights are non-zero only at gy in
// {floor(ry), floor(ry) + 1} and gx in {floor(rx), floor(rx) + 1}, so here
// the sum is exactly a bilinear read of at most four window pixels per
// point, each kept only if it lies inside the window. No weight row is
// built.
//
// What bounds it on this card: reads of the window pixels. The tile buffer
// (n_tiles, K*K, H*D) is made by the caller; at the flagship's finest level
// and K = 28 it is ~1 GB in bfloat16 per frame, far beyond L2 (50 MB), and
// each point reads four 64-byte corners of it. Arithmetic is negligible.
//
// Layout: one thread per 16-byte vector of the output, threads ordered
// (row, head, vector), so at D = 32 bf16 a warp makes one row's 8 heads and
// a block of 256 threads 8 consecutive rows, which belong to one or two
// row-blocks and so read inside one or two windows (401 KB each at K = 28
// in bf16, held in L2). A thread reads its (row, head)'s rel as vectors and
// issues the corner loads of a batch of points (predicated,
// vec16.cuh::bilinear_batch) before their multiply-adds (see kBatch).
// Instances: P = 4 or 8 known at compile time, and any P at run time.
// When D * esize is no multiple of 16 bytes or a pointer is not 16-byte
// aligned the wrapper launches the generic instance: the same kernel with
// one element per thread and scalar loads. A tile id outside the buffer
// reads nothing and gives zero rows. Sums are float32, per output element
// in the order points -> corners.

#include <cuda_runtime.h>
#include <stdint.h>

#include "vec16.cuh"

namespace {

using namespace mvg_vec;

constexpr int kThreads = 256;
// points per batch of corner loads: 4 * kBatch loads in flight per thread,
// batch after batch in a loop the compiler keeps rolled. All four points of
// P = 4 as one straight-line batch took 142 registers in bf16 (one block of
// 256 threads per SM) and ran at less than half the speed; batches of 2
// take 58.
constexpr int kBatch = 2;

// V elements per thread (kVec<T>, or 1 for the generic instance); kP the
// points when known at compile time, else 0.
template <typename T, int V, int kP>
__global__ void __launch_bounds__(kThreads)
window_block_fwd_kernel(const T* __restrict__ tiles,
                        const float* __restrict__ rel,
                        const int* __restrict__ block_tile,
                        T* __restrict__ out, int n_tiles, int nrows, int K,
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
  const int tile = block_tile[r / block_rows];
  // a tile id outside the buffer reads nothing; the caller's plan never
  // makes one
  const bool tile_ok = tile >= 0 && tile < n_tiles;
  const float* rel_t = rel + (int64_t)rh * 3 * P;  // [ry(P) | rx(P) | aw(P)]
  const T* win =
      tiles + (tile_ok ? (int64_t)tile * K * K * hd : 0) + h * D + j * V;

  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
#pragma unroll 1
  for (int p0 = 0; p0 < P; p0 += kB) {
    float y[kB], x[kB], a[kB];
    const int have = tile_ok ? (kP > 0 ? kB : min(kB, P - p0)) : 0;
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
    bilinear_batch<T, V, kB>(acc, y, x, a, have, win, K * hd, hd, K, K);
  }
  store<T, V>(out + (int64_t)r * hd + h * D + j * V, acc);
}

template <typename T, int V, int kP>
int launch_one(const void* tiles, const float* rel, const int* block_tile,
               void* out, int n_tiles, int nrows, int K, int H, int P, int D,
               int block_rows, cudaStream_t stream) {
  const int64_t threads = (int64_t)nrows * H * (D / V);
  if (threads > INT32_MAX - kThreads) return -1;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks == 0) return (int)cudaSuccess;
  window_block_fwd_kernel<T, V, kP><<<(unsigned)blocks, kThreads, 0,
                                      stream>>>(
      static_cast<const T*>(tiles), rel, block_tile, static_cast<T*>(out),
      n_tiles, nrows, K, H, P, D, block_rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* tiles, const float* rel, const int* block_tile,
           void* out, int n_tiles, int nrows, int K, int H, int P, int D,
           int block_rows, int vec, cudaStream_t stream) {
  constexpr int kV = kVec<T>;
  if (vec == 1)
    return launch_one<T, 1, 0>(tiles, rel, block_tile, out, n_tiles, nrows,
                               K, H, P, D, block_rows, stream);
  if (vec != kV || D % kV != 0) return -1;
  if (P == 4)
    return launch_one<T, kV, 4>(tiles, rel, block_tile, out, n_tiles, nrows,
                                K, H, P, D, block_rows, stream);
  if (P == 8)
    return launch_one<T, kV, 8>(tiles, rel, block_tile, out, n_tiles, nrows,
                                K, H, P, D, block_rows, stream);
  return launch_one<T, kV, 0>(tiles, rel, block_tile, out, n_tiles, nrows, K,
                              H, P, D, block_rows, stream);
}

}  // namespace

// C interface, bound with ctypes. tiles (n_tiles, K*K, H*D), rel
// (nrows, H*3P) float32, block_tile (nrows / block_rows,) int32, out
// (nrows, H*D). dtype: 0 = float32, 1 = bfloat16 (tiles and out share it).
// vec: elements per thread, 16 / esize (tiles, rel and out 16-byte aligned,
// D * esize a multiple of 16) or 1 (the generic instance). Returns the
// cudaError_t of the launch; -1 for arguments the kernel does not take.
extern "C" int mvg_window_block_forward(const void* tiles, const void* rel,
                                        const void* block_tile, void* out,
                                        int n_tiles, int nrows, int K, int H,
                                        int P, int D, int block_rows,
                                        int dtype, int vec, void* stream) {
  if (K < 1 || H < 1 || P < 1 || D < 1 || block_rows < 1 ||
      nrows % block_rows != 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* relf = static_cast<const float*>(rel);
  const int* bt = static_cast<const int*>(block_tile);
  if (dtype == 0)
    return launch<float>(tiles, relf, bt, out, n_tiles, nrows, K, H, P, D,
                         block_rows, vec, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(tiles, relf, bt, out, n_tiles, nrows, K, H,
                                 P, D, block_rows, vec, s);
  return -1;
}
