// Device code of the windowed layer-1 sampling kernel window_dma.cu (B5).
// window_block.cu (B4) computes the same sum with vector loads through
// vec16.cuh::bilinear_batch.
//
// Both compute, for one row r and head h of a block of tile-sorted rows,
//
//   out[r, h*D:(h+1)*D] = sum_{gy < K, gx < Kw} rw[gy, gx] * win[gy, gx, h*D:(h+1)*D]
//   rw = sum_p aw_p * relu(1 - |ry_p - gy|) * relu(1 - |rx_p - gx|)
//
// where rel[r] packs, per head, [ry(P) | rx(P) | aw(P)] in window pixels.
// The TPU kernels build the K*Kw-wide row rw and multiply it into the window
// on the MXU. Here the tent weights are non-zero only at gy in {floor(ry),
// floor(ry) + 1} and gx in {floor(rx), floor(rx) + 1}, so the sum over the
// window is exactly a bilinear read of at most four window pixels per
// point, each kept only if it lies inside [0, K) x [0, Kw). No weight row is
// built.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mvg_window {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// sum_p aw_p * bilinear(win, ry_p, rx_p) at one channel of one (row, head).
// rel_h: this (row, head)'s [ry(P) | rx(P) | aw(P)].
// win:   the window's pixel (0, 0) at this channel; y_stride and x_stride are
//        the element strides of one window row and one window column.
// The overlap test runs BEFORE the float -> int cast: a NaN, +-inf or huge
// coordinate fails it, adds nothing and never reads outside the window.
template <typename T>
__device__ __forceinline__ float window_point_sum(
    const float* __restrict__ rel_h, int P, const T* __restrict__ win,
    int64_t y_stride, int64_t x_stride, int K, int Kw) {
  float acc = 0.f;
  for (int p = 0; p < P; ++p) {
    const float ry = rel_h[p], rx = rel_h[P + p], aw = rel_h[2 * P + p];
    if (!(ry > -1.f && ry < (float)K && rx > -1.f && rx < (float)Kw))
      continue;
    const float yf = floorf(ry), xf = floorf(rx);
    const int y0 = (int)yf, x0 = (int)xf;
    const float ly = ry - yf, lx = rx - xf;
    float s = 0.f;
    if (y0 >= 0) {
      const T* r = win + y0 * y_stride;
      if (x0 >= 0) s += (1.f - ly) * (1.f - lx) * load_f(r + x0 * x_stride);
      if (x0 + 1 < Kw) s += (1.f - ly) * lx * load_f(r + (x0 + 1) * x_stride);
    }
    if (y0 + 1 < K) {
      const T* r = win + (y0 + 1) * y_stride;
      if (x0 >= 0) s += ly * (1.f - lx) * load_f(r + x0 * x_stride);
      if (x0 + 1 < Kw) s += ly * lx * load_f(r + (x0 + 1) * x_stride);
    }
    acc += aw * s;
  }
  return acc;
}

}  // namespace mvg_window
