// Multi-scale deformable sampling, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel mvgformer_tpu/ops/pallas_deform.py::_kernel
// (wrapper deform_sample_pallas), whose contract is
// mvgformer_tpu/ops/sampling.py::deform_sample / deform_sample_corner:
//
//   out[n, q, h*D + d] = sum_{l, p} aw[n, q, h, l, p] *
//                        bilinear(value_l[n, :, h, d], loc[n, q, h, l, p])
//
// with pixel coordinates x = loc_x * w - 0.5, y = loc_y * h - 0.5 and zero
// padding outside each level's map.
//
// The TPU kernel reads one row of a padded 4-corner table per sample,
// because the TPU gather pays per slice. Here there is no table: the four
// corners are read directly from `value`, each bounds-checked.
//
// What bounds it on this card: random corner reads. At flagship size one
// corner of one head is D = 32 bf16 = 64 bytes, and `value` is
// 5 views x 40320 positions x 256 channels x 2 bytes ~= 103 MB per decoder
// layer, the size of L2 (50 MB) twice over, so the reads land in L2 or DRAM
// at 64-byte granularity, and the time is set by how many of them are in
// flight. Arithmetic is negligible.
//
// Layout: one thread per 16-byte vector of the output, threads ordered
// (n, q, h, vector). At D = 32 bf16 that is 4 threads per (n, q, h) and one
// warp per query's 8 heads, whose output store is one contiguous 512-byte
// write. A thread reads its (n, q, h)'s locations and weights of a level as
// vectors, computes the corner addresses and in-bounds masks of all the
// level's points, and issues the level's 4 * P corner loads (predicated:
// an off-map corner loads nothing and reads as zero, from a safe address)
// before any multiply-add, so 4 * P 16-byte loads are in flight per thread
// (P <= 4; at P = 8 two batches of 4 points, see kBatch). Instances: L = 3
// with P = 2, 4 or 8 (bf16) known at compile time (the model's shapes);
// any L <= 4 and P at run time, 4 points per batch. When D * esize is no
// multiple of 16 bytes or a pointer is not 16-byte aligned the wrapper
// launches the generic instance: the same kernel with one element per
// thread and scalar loads.
//
// Sums are float32, per output element in the order levels -> points ->
// corners, each point's corner sum weighted by aw after it is formed.
//
// The overlap test runs BEFORE the float -> int cast: a NaN, +-inf or huge
// location fails it, contributes nothing and never reads out of bounds.

#include <cuda_runtime.h>
#include <stdint.h>

#include "vec16.cuh"

namespace {

using namespace mvg_vec;

constexpr int kMaxLevels = 4;
constexpr int kThreads = 256;
// points per batch of corner loads: 4 * kBatch 16-byte loads in flight per
// thread. A whole level at P = 8 (32 loads, 128 registers of data) took
// 255 registers and spilled in bf16, so P = 8 runs in two batches.
constexpr int kBatch = 4;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

// V elements per thread (kVec<T>, or 1 for the generic instance); kL, kP
// the levels and points when known at compile time, else 0.
template <typename T, int V, int kL, int kP>
__global__ void __launch_bounds__(kThreads)
deform_sample_fwd_kernel(const T* __restrict__ value,
                         const float* __restrict__ loc,
                         const T* __restrict__ aw, T* __restrict__ out,
                         int N, int len_in, int H, int D, int Lq, int L_,
                         int P_, Levels lv) {
  constexpr int kB = kP > 0 && kP < kBatch ? kP : kBatch;
  const int L = kL > 0 ? kL : L_;
  const int P = kP > 0 ? kP : P_;
  const int vpr = D / V;  // threads per (n, q, h)
  // the launcher keeps N * Lq * H * vpr below 2^31
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= N * Lq * H * vpr) return;
  const int nqh = t / vpr;
  const int j = t - nqh * vpr;
  const int h = nqh % H;
  const int n = nqh / (Lq * H);
  const int64_t row = (int64_t)H * D;  // stride of one position
  const T* v_n = value + (int64_t)n * len_in * row + h * D + j * V;
  const float* loc_t = loc + (int64_t)nqh * L * P * 2;  // (L, P, 2)
  const T* aw_t = aw + (int64_t)nqh * L * P;            // (L, P)

  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
  // kept a loop: unrolled over the levels, the compiler hoists the next
  // levels' loads, takes 180 registers at L 3 x P 4 in bf16 (one block of
  // 256 threads per SM) and runs at half the speed; as a loop, 61
#pragma unroll 1
  for (int l = 0; l < (kL > 0 ? kL : kMaxLevels); ++l) {
    if (l >= L) break;
    const int hl = lv.h[l], wl = lv.w[l];
    const T* v_l = v_n + (int64_t)lv.start[l] * row;
#pragma unroll 1
    for (int p0 = 0; p0 < P; p0 += kB) {
      float xy[2 * kB], x[kB], y[kB], a[kB];
      const int have = kP > 0 ? kB : min(kB, P - p0);
      if constexpr (kP > 0) {
        load_n<float, 2 * kB>(loc_t + (l * kP + p0) * 2, xy);
        load_n<T, kB>(aw_t + l * kP + p0, a);
      } else {
#pragma unroll
        for (int b = 0; b < kB; ++b) {
          const int i = l * P + p0 + (b < have ? b : 0);
          xy[2 * b] = loc_t[2 * i];
          xy[2 * b + 1] = loc_t[2 * i + 1];
          a[b] = to_f(aw_t[i]);
        }
      }
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        x[b] = xy[2 * b] * (float)wl - 0.5f;
        y[b] = xy[2 * b + 1] * (float)hl - 0.5f;
      }
      bilinear_batch<T, V, kB>(acc, y, x, a, have, v_l, wl * row, row, hl,
                               wl);
    }
  }
  store<T, V>(out + (int64_t)nqh * D + j * V, acc);
}

template <typename T, int V, int kL, int kP>
int launch_one(const void* value, const float* loc, const void* aw,
               void* out, int N, int len_in, int H, int D, int Lq, int L,
               int P, const Levels& lv, cudaStream_t stream) {
  const int64_t threads = (int64_t)N * Lq * H * (D / V);
  if (threads > INT32_MAX - kThreads) return -1;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks == 0) return (int)cudaSuccess;
  deform_sample_fwd_kernel<T, V, kL, kP>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(
          static_cast<const T*>(value), loc, static_cast<const T*>(aw),
          static_cast<T*>(out), N, len_in, H, D, Lq, L, P, lv);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* value, const float* loc, const void* aw, void* out,
           int N, int len_in, int H, int D, int Lq, int L, int P,
           const Levels& lv, int vec, cudaStream_t stream) {
  constexpr int kV = kVec<T>;
  if (vec == 1)
    return launch_one<T, 1, 0, 0>(value, loc, aw, out, N, len_in, H, D, Lq,
                                  L, P, lv, stream);
  if (vec != kV || D % kV != 0) return -1;
  if (L == 3 && P == 2)
    return launch_one<T, kV, 3, 2>(value, loc, aw, out, N, len_in, H, D, Lq,
                                   L, P, lv, stream);
  if (L == 3 && P == 4)
    return launch_one<T, kV, 3, 4>(value, loc, aw, out, N, len_in, H, D, Lq,
                                   L, P, lv, stream);
  // P = 8 at compile time in bf16 only: the float32 instance spilled 12
  // bytes (ptxas); the run-time instance does not
  if constexpr (sizeof(T) == 2) {
    if (L == 3 && P == 8)
      return launch_one<T, kV, 3, 8>(value, loc, aw, out, N, len_in, H, D,
                                     Lq, L, P, lv, stream);
  }
  return launch_one<T, kV, 0, 0>(value, loc, aw, out, N, len_in, H, D, Lq, L,
                                 P, lv, stream);
}

}  // namespace

// C interface, bound with ctypes. `levels` is a host array of 3*L ints:
// (h, w, start) per level. dtype: 0 = float32, 1 = bfloat16 (value, aw and
// out share it; loc is float32). vec: elements per thread, 16 / esize (all
// four pointers 16-byte aligned, D * esize a multiple of 16) or 1 (the
// generic instance). Returns the cudaError_t of the launch; -1 for
// arguments the kernel does not take.
extern "C" int mvg_deform_sample_forward(const void* value, const void* loc,
                                         const void* aw, void* out, int N,
                                         int len_in, int H, int D, int Lq,
                                         int L, int P, const int* levels,
                                         int dtype, int vec, void* stream) {
  if (L < 1 || L > kMaxLevels || P < 1 || D < 1) return -1;
  Levels lv;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = levels[3 * l];
    lv.w[l] = levels[3 * l + 1];
    lv.start[l] = levels[3 * l + 2];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* locf = static_cast<const float*>(loc);
  if (dtype == 0)
    return launch<float>(value, locf, aw, out, N, len_in, H, D, Lq, L, P, lv,
                         vec, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(value, locf, aw, out, N, len_in, H, D, Lq,
                                 L, P, lv, vec, s);
  return -1;
}
