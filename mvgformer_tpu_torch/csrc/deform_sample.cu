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
// at 64-byte granularity. Arithmetic is negligible.
//
// Layout (simple, correct first): one warp per (n, q, h); lanes run over D,
// so a corner read is one coalesced 32-lane load of D contiguous elements.
// Every lane computes the (identical) sample position, so the branch that
// skips a sample is uniform across the warp. Sums are float32.
//
// The overlap test runs BEFORE the float -> int cast: a NaN, +-inf or huge
// location fails it and contributes nothing, and never reads out of bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kWarpsPerBlock = 8;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

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
deform_sample_fwd_kernel(const T* __restrict__ value,
                         const float* __restrict__ loc,
                         const T* __restrict__ aw, T* __restrict__ out,
                         int N, int len_in, int H, int D, int Lq, int L,
                         int P, Levels lv) {
  const int64_t warp =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= (int64_t)N * Lq * H) return;
  const int h = (int)(warp % H);
  const int n = (int)(warp / ((int64_t)Lq * H));

  const float* loc_w = loc + warp * L * P * 2;  // (L, P, 2) of this warp
  const T* aw_w = aw + warp * L * P;            // (L, P)
  const int64_t row = (int64_t)H * D;           // stride of one position
  const T* v_n = value + (int64_t)n * len_in * row + (int64_t)h * D;

  for (int d = lane; d - lane < D; d += 32) {
    const bool active = d < D;
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      const int hl = lv.h[l], wl = lv.w[l];
      const T* v_l = v_n + (int64_t)lv.start[l] * row + d;
      for (int p = 0; p < P; ++p) {
        const int i = l * P + p;
        const float x = loc_w[2 * i] * (float)wl - 0.5f;
        const float y = loc_w[2 * i + 1] * (float)hl - 0.5f;
        if (!(x > -1.f && x < (float)wl && y > -1.f && y < (float)hl))
          continue;
        const float xf = floorf(x), yf = floorf(y);
        const int x0 = (int)xf, y0 = (int)yf;
        const float lx = x - xf, ly = y - yf;
        float s = 0.f;
        if (active) {
          if (y0 >= 0) {
            const T* r = v_l + (int64_t)y0 * wl * row;
            if (x0 >= 0) s += (1.f - lx) * (1.f - ly) * load_f(r + x0 * row);
            if (x0 + 1 < wl) s += lx * (1.f - ly) * load_f(r + (x0 + 1) * row);
          }
          if (y0 + 1 < hl) {
            const T* r = v_l + (int64_t)(y0 + 1) * wl * row;
            if (x0 >= 0) s += (1.f - lx) * ly * load_f(r + x0 * row);
            if (x0 + 1 < wl) s += lx * ly * load_f(r + (x0 + 1) * row);
          }
        }
        acc += load_f(aw_w + i) * s;
      }
    }
    if (active) store_f(out + warp * D + d, acc);
  }
}

template <typename T>
int launch(const void* value, const float* loc, const void* aw, void* out,
           int N, int len_in, int H, int D, int Lq, int L, int P,
           const Levels& lv, cudaStream_t stream) {
  const int64_t warps = (int64_t)N * Lq * H;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks == 0) return (int)cudaSuccess;
  deform_sample_fwd_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                                 stream>>>(
      static_cast<const T*>(value), loc, static_cast<const T*>(aw),
      static_cast<T*>(out), N, len_in, H, D, Lq, L, P, lv);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes. `levels` is a host array of 3*L ints:
// (h, w, start) per level. dtype: 0 = float32, 1 = bfloat16 (value, aw and
// out share it; loc is float32). Returns the cudaError_t of the launch;
// -1 for arguments the kernel does not take.
extern "C" int mvg_deform_sample_forward(const void* value, const void* loc,
                                         const void* aw, void* out, int N,
                                         int len_in, int H, int D, int Lq,
                                         int L, int P, const int* levels,
                                         int dtype, void* stream) {
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
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(value, locf, aw, out, N, len_in, H, D, Lq,
                                 L, P, lv, s);
  return -1;
}
