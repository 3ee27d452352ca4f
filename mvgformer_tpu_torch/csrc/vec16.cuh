// Vector loads and stores of the sampling kernels (deform_sample.cu,
// window_block.cu, window_dma.cu): a thread moves N consecutive elements of
// a row at once, N * sizeof(T) bytes in one load of at most 16 bytes (8
// bfloat16 or 4 float32 values; N = 1 is the generic instance's element
// load), widens them to float32 registers only where it multiplies, and
// narrows its float32 sums back to T in one store.
//
//   Pack<T, N>       the raw bits of N elements, as one register-sized value
//   load<T, N>       one read-only (__ldg) load of a Pack; the pointer is
//                    aligned to its size
//   load_if<T, N>    the same, predicated: zero bits where `ok` is false, so
//                    the loads of a batch can all be issued before any is used
//   madd<T, N>       acc[k] += w * element k, in float32 (fmaf)
//   store<T, N>      N float32 sums narrowed to T, one store
//   load_n<T, N>     N consecutive elements widened to float32, in loads of up
//                    to 16 bytes (N * sizeof(T) a power of two, the pointer
//                    aligned to it or to 16 bytes)
//   bilinear_batch   the weighted bilinear reads of a batch of points, every
//                    corner load of the batch in flight before the first
//                    multiply-add

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mvg_vec {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float& d, float v) { d = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16& d, float v) {
  d = __float2bfloat16(v);
}

template <int B> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// elements of T in one 16-byte vector
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

template <typename T, int N>
struct Pack {
  using R = typename Raw<N * (int)sizeof(T)>::type;
  R raw;
};

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> load(const T* __restrict__ p) {
  using R = typename Pack<T, N>::R;
  return Pack<T, N>{__ldg(reinterpret_cast<const R*>(p))};
}

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> load_if(bool ok,
                                              const T* __restrict__ p) {
  using R = typename Pack<T, N>::R;
  Pack<T, N> v{R{}};
  if (ok) v.raw = __ldg(reinterpret_cast<const R*>(p));
  return v;
}

template <typename T, int N>
__device__ __forceinline__ void madd(float (&acc)[N], float w,
                                     const Pack<T, N>& v) {
  const T* e = reinterpret_cast<const T*>(&v.raw);
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = fmaf(w, to_f(e[k]), acc[k]);
}

template <typename T, int N>
__device__ __forceinline__ void store(T* __restrict__ p,
                                      const float (&v)[N]) {
  using R = typename Pack<T, N>::R;
  Pack<T, N> out;
  T* e = reinterpret_cast<T*>(&out.raw);
#pragma unroll
  for (int k = 0; k < N; ++k) from_f(e[k], v[k]);
  *reinterpret_cast<R*>(p) = out.raw;
}

template <typename T, int N>
__device__ __forceinline__ void load_n(const T* __restrict__ p,
                                       float (&v)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  constexpr int kPart = kBytes < 16 ? kBytes : 16;
  constexpr int kPer = kPart / (int)sizeof(T);
#pragma unroll
  for (int q = 0; q < kBytes / kPart; ++q) {
    const Pack<T, kPer> part = load<T, kPer>(p + q * kPer);
    const T* e = reinterpret_cast<const T*>(&part.raw);
#pragma unroll
    for (int k = 0; k < kPer; ++k) v[q * kPer + k] = to_f(e[k]);
  }
}

// acc += sum_{b < have} a[b] * bilinear(grid, y[b], x[b]) for kB points at
// pixel coordinates (y, x) of an (h, w) grid of N-element vectors, zero
// outside: corner (gy, gx) is at base + gy * y_stride + gx * x_stride
// (element strides).
// A point whose stencil misses the grid (the test runs before the float ->
// int cast, so NaN, +-inf and huge coordinates fail it) adds nothing and
// reads nothing; an off-grid corner of a point that overlaps is a predicated
// load from `base`, reading zero bits. All 4 * kB loads are issued before any
// multiply-add. Per point the four corners are summed in the order (y0, x0),
// (y0, x0+1), (y0+1, x0), (y0+1, x0+1), then weighted by a[b] into acc.
template <typename T, int N, int kB>
__device__ __forceinline__ void bilinear_batch(
    float (&acc)[N], const float (&y)[kB], const float (&x)[kB],
    const float (&a)[kB], int have, const T* __restrict__ base,
    int64_t y_stride, int64_t x_stride, int h, int w) {
  Pack<T, N> c[kB][4];
  float lx[kB], ly[kB], aw[kB];
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    const bool in = b < have && x[b] > -1.f && x[b] < (float)w &&
                    y[b] > -1.f && y[b] < (float)h;
    // outside: a finite stand-in, every corner masked
    const float xc = in ? x[b] : 0.f, yc = in ? y[b] : 0.f;
    const float xf = floorf(xc), yf = floorf(yc);
    const int x0 = (int)xf, y0 = (int)yf;
    lx[b] = xc - xf;
    ly[b] = yc - yf;
    aw[b] = in ? a[b] : 0.f;
    const bool ok[4] = {in && y0 >= 0 && x0 >= 0,
                        in && y0 >= 0 && x0 + 1 < w,
                        in && y0 + 1 < h && x0 >= 0,
                        in && y0 + 1 < h && x0 + 1 < w};
    const int64_t o = y0 * y_stride + x0 * x_stride;
    const int64_t off[4] = {o, o + x_stride, o + y_stride,
                            o + y_stride + x_stride};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      c[b][k] = load_if<T, N>(ok[k], base + (ok[k] ? off[k] : 0));
  }
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    float s[N];
#pragma unroll
    for (int k = 0; k < N; ++k) s[k] = 0.f;
    madd(s, (1.f - lx[b]) * (1.f - ly[b]), c[b][0]);
    madd(s, lx[b] * (1.f - ly[b]), c[b][1]);
    madd(s, (1.f - lx[b]) * ly[b], c[b][2]);
    madd(s, lx[b] * ly[b], c[b][3]);
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] = fmaf(aw[b], s[k], acc[k]);
  }
}

}  // namespace mvg_vec
