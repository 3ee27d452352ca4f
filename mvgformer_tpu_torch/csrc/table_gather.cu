// Corner-table gather-reduce, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel mvgformer_tpu/ops/onehot_gather.py::_onehot_kernel
// (wrappers _onehot_select and deform_gather_reduce), whose contract is
//
//   out[p, s, d] = sum_c tables[p, idx[p, s], c*D + d] * w4[p, s, c]
//
// for tables (NH, R, 4D), idx (NH, S) int32, w4 (NH, S, 4). The TPU kernel
// sorts the samples and selects rows with a one-hot matmul, because Mosaic
// cannot lower a row gather; the escape repair and the fallback around it
// exist for the same reason. A Hopper warp gathers rows directly, so here
// there is no sort, no window and no repair.
//
// The backward (JAX differentiates the plain gather-reduce) is one kernel:
//
//   grad_tables[p, idx[p, s], c*D + d] += w4[p, s, c] * ct[p, s, d]
//   grad_w4[p, s, c] = sum_d tables[p, idx[p, s], c*D + d] * ct[p, s, d]
//
// with float32 atomic adds into a zeroed float32 buffer (the wrapper casts
// it to the table dtype) and a warp-reduced dot per corner.
//
// What bounds it on this card: random row reads (and, backward, atomic
// adds into L2). At the flagship training shape one decoder layer gathers
// 40 pairs x 368,640 samples of one 256-byte bf16 row each, ~3.8 GB, from
// 450 MB of tables, over the 50 MB L2.
//
// Layout (simple, correct first): one warp per (pair, sample), lanes over
// D, so a corner is one coalesced read of D contiguous channels; sums are
// float32. A row index outside [0, R) reads and writes nothing, so the
// kernel never touches memory outside the table. The backward skips the
// atomic add of a corner whose weight is exactly 0 (samples that miss the
// map, and the zero corners at its border): it would add 0 * ct.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_reduce_fwd_kernel(const T* __restrict__ tables,
                         const int* __restrict__ idx,
                         const T* __restrict__ w4, T* __restrict__ out,
                         int NH, int R, int S, int D) {
  const int64_t warp =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= (int64_t)NH * S) return;
  const int64_t p = warp / S;
  const int r = idx[warp];
  const bool ok = r >= 0 && r < R;  // the same for every lane
  float wc[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) wc[c] = load_f(w4 + warp * 4 + c);
  const T* row = tables + (p * R + (ok ? r : 0)) * 4 * D;
  for (int d = lane; d < D; d += 32) {
    float acc = 0.f;
    if (ok) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc += wc[c] * load_f(row + c * D + d);
    }
    store_f(out + warp * D + d, acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_reduce_bwd_kernel(const T* __restrict__ tables,
                         const int* __restrict__ idx,
                         const T* __restrict__ w4, const T* __restrict__ ct,
                         float* __restrict__ grad_tables,
                         T* __restrict__ grad_w4, int NH, int R, int S,
                         int D) {
  const int64_t warp =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= (int64_t)NH * S) return;
  const int64_t p = warp / S;
  const int r = idx[warp];
  const bool ok = r >= 0 && r < R;
  float wc[4], dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < 4; ++c) wc[c] = load_f(w4 + warp * 4 + c);
  const int64_t base = (p * R + (ok ? r : 0)) * 4 * D;
  if (ok) {
    for (int d = lane; d < D; d += 32) {
      const float g = load_f(ct + warp * D + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dot[c] += load_f(tables + base + c * D + d) * g;
        if (wc[c] != 0.f) atomicAdd(grad_tables + base + c * D + d, wc[c] * g);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    for (int off = 16; off > 0; off >>= 1)
      dot[c] += __shfl_xor_sync(0xffffffffu, dot[c], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) store_f(grad_w4 + warp * 4 + c, dot[c]);
  }
}

unsigned blocks_for(int NH, int S) {
  return (unsigned)(((int64_t)NH * S + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

// C interface, bound with ctypes. tables (NH, R, 4D), w4 (NH, S, 4), out
// (NH, S, D), all contiguous in one dtype: 0 = float32, 1 = bfloat16; idx
// (NH, S) int32. Returns the cudaError_t of the launch; -1 for arguments
// the kernel does not take.
extern "C" int mvg_table_gather_forward(const void* tables, const void* idx,
                                        const void* w4, void* out, int NH,
                                        int R, int S, int D, int dtype,
                                        void* stream) {
  if (NH < 0 || R < 1 || S < 0 || D < 1) return -1;
  if ((int64_t)NH * S == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  if (dtype == 0) {
    gather_reduce_fwd_kernel<float>
        <<<blocks_for(NH, S), kWarpsPerBlock * 32, 0, s>>>(
            static_cast<const float*>(tables), ix,
            static_cast<const float*>(w4), static_cast<float*>(out), NH, R, S,
            D);
  } else if (dtype == 1) {
    gather_reduce_fwd_kernel<__nv_bfloat16>
        <<<blocks_for(NH, S), kWarpsPerBlock * 32, 0, s>>>(
            static_cast<const __nv_bfloat16*>(tables), ix,
            static_cast<const __nv_bfloat16*>(w4),
            static_cast<__nv_bfloat16*>(out), NH, R, S, D);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}

// ct (NH, S, D) and grad_w4 (NH, S, 4) in the dtype of tables; grad_tables
// is a float32 (NH, R, 4D) buffer that the caller has zeroed.
extern "C" int mvg_table_gather_backward(const void* tables, const void* idx,
                                         const void* w4, const void* ct,
                                         void* grad_tables, void* grad_w4,
                                         int NH, int R, int S, int D,
                                         int dtype, void* stream) {
  if (NH < 0 || R < 1 || S < 0 || D < 1) return -1;
  if ((int64_t)NH * S == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  float* gt = static_cast<float*>(grad_tables);
  if (dtype == 0) {
    gather_reduce_bwd_kernel<float>
        <<<blocks_for(NH, S), kWarpsPerBlock * 32, 0, s>>>(
            static_cast<const float*>(tables), ix,
            static_cast<const float*>(w4), static_cast<const float*>(ct), gt,
            static_cast<float*>(grad_w4), NH, R, S, D);
  } else if (dtype == 1) {
    gather_reduce_bwd_kernel<__nv_bfloat16>
        <<<blocks_for(NH, S), kWarpsPerBlock * 32, 0, s>>>(
            static_cast<const __nv_bfloat16*>(tables), ix,
            static_cast<const __nv_bfloat16*>(w4),
            static_cast<const __nv_bfloat16*>(ct), gt,
            static_cast<__nv_bfloat16*>(grad_w4), NH, R, S, D);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
