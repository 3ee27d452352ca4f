// Padded 4-corner table of one feature level, for Hopper (sm_90a).
//
// Replaces the TPU kernel mvgformer_tpu/ops/table_pallas.py::_build_kernel
// (wrapper build_corner_table_level). For a level of size (h, w) and each
// (view, head) pair p = n * H + hh it writes
//
//   out[p, y * wpp + x, c*D : (c+1)*D] = v[n, hh, y - 1 + c / 2, x - 1 + c % 2]
//
// for y in [0, h + 2), x in [0, wpp) and corner c in 0..3, and zeros where
// that pixel lies outside the (h, w) map. wpp = round_up(w + 2, 16), the
// TPU kernel's lane-aligned row stride, kept so the tables are the same
// arrays as JAX's. A sample whose stencil's top-left pixel is (y0, x0)
// reads the one row (y0 + 1) * wpp + x0 + 1.
//
// What bounds it on this card: bytes. It is a pure copy: every output
// element is one input element or zero. At flagship size one decoder
// layer's three tables are 40 pairs x 43,904 rows x 128 channels = 450 MB
// in bf16 written, from a 103 MB value read four times (mostly from L2).
//
// Layout: one thread per 16-byte vector of output where the strides allow
// it (8 bf16 or 4 float32 channels), else per 8, 4 or 2 bytes. Neighbouring
// threads write neighbouring vectors of one row, so the stores coalesce;
// the reads of one corner are D contiguous channels of one pixel. The copy
// moves raw bits, so it is exact for every dtype of the element size.
// The input is read through its strides: the caller passes a view of the
// (N, Len_in, H, D) value projection with no transpose copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename V>
__global__ void __launch_bounds__(kThreads)
table_build_kernel(const V* __restrict__ src, V* __restrict__ dst, int H,
                   int h, int w, int wpp, int dv, int64_t s_n, int64_t s_h,
                   int64_t s_y, int64_t s_x, int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int row_v = 4 * dv;  // one table row, in units of V
  const int col = (int)(i % row_v);
  int64_t r = i / row_v;
  const int x = (int)(r % wpp);
  r /= wpp;
  const int y = (int)(r % (h + 2));
  const int64_t p = r / (h + 2);
  const int c = col / dv;
  const int d = col - c * dv;
  const int sy = y - 1 + (c >> 1);
  const int sx = x - 1 + (c & 1);
  V val = V();
  if (sy >= 0 && sy < h && sx >= 0 && sx < w) {
    const int64_t n = p / H;
    const int64_t hh = p - n * H;
    val = src[n * s_n + hh * s_h + sy * s_y + sx * s_x + d];
  }
  dst[i] = val;
}

template <typename V>
int launch(const void* src, void* dst, int N, int H, int h, int w, int wpp,
           int D, int esize, const int64_t* strides, cudaStream_t stream) {
  const int64_t per = (int64_t)sizeof(V) / esize;  // elements per vector
  const int dv = (int)(D / per);
  const int64_t total = (int64_t)N * H * (h + 2) * wpp * 4 * dv;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks == 0) return (int)cudaSuccess;
  table_build_kernel<V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(src), static_cast<V*>(dst), H, h, w, wpp, dv,
      strides[0] / per, strides[1] / per, strides[2] / per, strides[3] / per,
      total);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int64_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// C interface, bound with ctypes. src holds v[n, hh, y, x, d] at
// src + n*s_n + hh*s_h + y*s_y + x*s_x + d (strides in elements, the
// channel stride is 1); dst is a contiguous (N*H, (h+2)*wpp, 4*D) table.
// esize: bytes per element (2 or 4). Returns the cudaError_t of the
// launch; -1 for arguments the kernel does not take.
extern "C" int mvg_table_build(const void* src, void* dst, int N, int H,
                               int h, int w, int wpp, int D, int esize,
                               long long s_n, long long s_h, long long s_y,
                               long long s_x, void* stream) {
  if (N < 0 || H < 1 || h < 1 || w < 1 || D < 1 || wpp < w + 2 ||
      (esize != 2 && esize != 4))
    return -1;
  const int64_t strides[4] = {(int64_t)s_n, (int64_t)s_h, (int64_t)s_y,
                              (int64_t)s_x};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the widest vector that every row, stride and pointer is aligned to
  for (int64_t vb = 16; vb >= esize; vb /= 2) {
    bool ok = (int64_t)D * esize % vb == 0 && aligned(src, vb) &&
              aligned(dst, vb);
    for (int k = 0; k < 4; ++k) ok = ok && strides[k] * esize % vb == 0;
    if (!ok) continue;
    switch (vb) {
      case 16:
        return launch<uint4>(src, dst, N, H, h, w, wpp, D, esize, strides, s);
      case 8:
        return launch<uint2>(src, dst, N, H, h, w, wpp, D, esize, strides, s);
      case 4:
        return launch<unsigned int>(src, dst, N, H, h, w, wpp, D, esize,
                                    strides, s);
      default:
        return launch<unsigned short>(src, dst, N, H, h, w, wpp, D, esize,
                                      strides, s);
    }
  }
  return -1;
}
