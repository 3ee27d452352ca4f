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
// The same kernel writes the corner-table store patterns of the table
// probe (ops/gather_forms.py::table_slots; replaces
// tools/probes/probe_table_kernel_forms.py::form_d's d0, d1, d3 and d4):
// slot c of row (y, x) holds v[y - 1 + row_c, x - shift_c] for the slot
// code 2 * row_c + shift_c, and zeros for the code -1 (slot off). B2's map
// is the codes (1, 0, 3, 2), and it has its own compile-time instance, so
// the training path's kernel reads no codes.
//
// What bounds it on this card: bytes. It is a pure copy: every output
// element is one input element or zero. At flagship size one decoder
// layer's three tables are 40 pairs x 43,904 rows x 128 channels = 450 MB
// in bf16 written, from a 103 MB value read four times (mostly from L2).
//
// Layout: a thread per table row and 16-byte vector of channels (8 bf16 or
// 4 float32; 8, 4 or 2 bytes where the strides allow no wider): it issues
// the loads of its row's four slots at that vector, then their four
// stores, so each thread keeps four loads in flight. A block covers a run
// of whole table rows of one pair, the pair from the grid's y (and z)
// index and the row from its x index, so a thread splits its row into
// (y, x) once, in 32 bits, and nothing divides a 64-bit index; B2's
// instance has its four slot offsets at compile time. Neighbouring threads
// take neighbouring vectors of one row, then the next row: each of a
// warp's four stores writes whole 32-byte sectors, and a corner's reads are
// D contiguous channels of one pixel, neighbouring pixels for neighbouring
// rows. The copy moves raw bits, so it is exact for every dtype of the
// element size. The input is read through its strides: the caller passes a
// view of the (N, Len_in, H, D) value projection with no transpose copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

// the code of slot c: B2's (1, 0, 3, 2), or the run-time codes packed as
// code + 1 in 4 bits each
template <bool kB2>
__device__ __forceinline__ int slot_code(int c, unsigned packed) {
  if (kB2) return (c & 2) | (1 - (c & 1));
  return (int)((packed >> (4 * c)) & 15u) - 1;
}

// grid (ceil(rows / rows_per_block), min(NH, kMaxGridY), ceil(NH /
// kMaxGridY)); a block writes rows_per_block table rows of pair
// blockIdx.z * gridDim.y + blockIdx.y, thread t the vector t % dv of row
// t / dv (rows over kThreads vectors: one row per block, a strided loop)
template <typename V, bool kB2>
__global__ void __launch_bounds__(kThreads)
table_build_kernel(const V* __restrict__ src, V* __restrict__ dst, int NH,
                   int H, int h, int w, int wpp, int dv, int64_t s_n,
                   int64_t s_h, int64_t s_y, int64_t s_x, unsigned codes,
                   int rows_per_block) {
  const int lr = threadIdx.x / dv;
  if (lr >= rows_per_block) return;
  const int rows = (h + 2) * wpp;
  const int r = blockIdx.x * rows_per_block + lr;
  const int p = blockIdx.z * gridDim.y + blockIdx.y;
  if (r >= rows || p >= NH) return;
  const int y = r / wpp;
  const int x = r - y * wpp;
  const int n = p / H;
  // pixel (y - 1, x) of pair p; the slot code k reads (y - 1 + k / 2,
  // x - k % 2)
  const V* in = src + n * s_n + (p - n * H) * s_h + (int64_t)(y - 1) * s_y +
                (int64_t)x * s_x;
  V* out = dst + ((int64_t)p * rows + r) * (4 * dv);
  for (int d = threadIdx.x - lr * dv; d < dv; d += kThreads) {
    V val[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int code = slot_code<kB2>(c, codes);
      const int sy = y - 1 + (code >> 1);
      const int sx = x - (code & 1);
      val[c] = V();
      if (code >= 0 && sy >= 0 && sy < h && sx >= 0 && sx < w)
        val[c] = in[(code >> 1) * s_y - (code & 1) * s_x + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c * dv + d] = val[c];
  }
}

template <typename V>
int launch(const void* src, void* dst, int N, int H, int h, int w, int wpp,
           int D, int esize, const int64_t* strides, bool b2,
           unsigned codes, cudaStream_t stream) {
  const int64_t per = (int64_t)sizeof(V) / esize;  // elements per vector
  const int dv = (int)(D / per);
  const int rpb = dv >= kThreads ? 1 : kThreads / dv;
  const int NH = N * H;
  const int rows = (h + 2) * wpp;
  if (NH == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((rows + rpb - 1) / rpb),
                  (unsigned)(NH < kMaxGridY ? NH : kMaxGridY),
                  (unsigned)((NH + kMaxGridY - 1) / kMaxGridY));
  const V* s = static_cast<const V*>(src);
  V* d = static_cast<V*>(dst);
  const int64_t sn = strides[0] / per, sh = strides[1] / per,
                sy = strides[2] / per, sx = strides[3] / per;
  if (b2)
    table_build_kernel<V, true><<<grid, kThreads, 0, stream>>>(
        s, d, NH, H, h, w, wpp, dv, sn, sh, sy, sx, codes, rpb);
  else
    table_build_kernel<V, false><<<grid, kThreads, 0, stream>>>(
        s, d, NH, H, h, w, wpp, dv, sn, sh, sy, sx, codes, rpb);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int64_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// C interface, bound with ctypes. src holds v[n, hh, y, x, d] at
// src + n*s_n + hh*s_h + y*s_y + x*s_x + d (strides in elements, the
// channel stride is 1); dst is a contiguous (N*H, (h+2)*wpp, 4*D) table.
// esize: bytes per element (2 or 4). s0..s3: the slot codes, -1 off, else
// 2 * row + shift (row 0 or 1, shift 0 or 1); (1, 0, 3, 2) is B2's table.
// Returns the cudaError_t of the launch; -1 for arguments the kernel does
// not take.
extern "C" int mvg_table_build(const void* src, void* dst, int N, int H,
                               int h, int w, int wpp, int D, int esize,
                               long long s_n, long long s_h, long long s_y,
                               long long s_x, int s0, int s1, int s2, int s3,
                               void* stream) {
  if (N < 0 || H < 1 || h < 1 || w < 1 || D < 1 || wpp < w + 2 ||
      (esize != 2 && esize != 4) || (int64_t)N * H > INT32_MAX ||
      (int64_t)(h + 2) * wpp > INT32_MAX)
    return -1;
  const int slots[4] = {s0, s1, s2, s3};
  unsigned codes = 0;
  for (int c = 0; c < 4; ++c) {
    if (slots[c] < -1 || slots[c] > 3) return -1;
    codes |= (unsigned)(slots[c] + 1) << (4 * c);
  }
  const bool b2 = s0 == 1 && s1 == 0 && s2 == 3 && s3 == 2;
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
        return launch<uint4>(src, dst, N, H, h, w, wpp, D, esize, strides,
                             b2, codes, s);
      case 8:
        return launch<uint2>(src, dst, N, H, h, w, wpp, D, esize, strides,
                             b2, codes, s);
      case 4:
        return launch<unsigned int>(src, dst, N, H, h, w, wpp, D, esize,
                                    strides, b2, codes, s);
      default:
        return launch<unsigned short>(src, dst, N, H, h, w, wpp, D, esize,
                                      strides, b2, codes, s);
    }
  }
  return -1;
}
