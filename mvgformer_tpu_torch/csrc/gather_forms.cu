// The gather forms of the probe kernels, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of tools/probes/ that are no form of B1-B3's
// own kernels: the row gathers, the one-hot selects, the take-along forms
// and the elementwise pass that those scripts compiled for the TPU (the
// corner-table store patterns of probe_table_kernel_forms.py are B2's
// kernel, csrc/table_build.cu, with their slot maps). Four kernels:
//
//   row gather   out[p, i, :] = tbl[p, r(p, i), :]
//                r = idx[p, i] (flat), or over blocks of BS samples
//                r = unit * base[p, b] + local[p, i]       (window select)
//                r = unit * base[p, b] + i - b * BS        (window copy)
//                and a zero row where r lies outside [0, R), where a window
//                select's local lies outside [0, W), and in mode "zero".
//     Replaces probe_pallas_gather.py::make_take_kernel (jnp.take) and
//     ::make_onehot_kernel, probe_pallas_gather2.py::onehot_kernel,
//     probe_mosaic_gather_forms.py forms f2, f3 and f6, and the windowed
//     one-hot selects of probe_onehot_parts.py::make_kernel (its four
//     variants are the modes select, copy and zero) and
//     probe_sorted_gather_parts.py::kernel. A one-hot product has one
//     non-zero term per output, so it is this gather; the TPU needed the
//     matrix unit because Mosaic lowers no row gather, and a Hopper thread
//     reads the row directly.
//   take-along   out[i, j] = tbl[idx[i, j], j]  (axis 0)
//                out[i, j] = tbl[i, idx[i, j]]  (axis 1), zero off the table.
//     Replaces probe_pallas_gather.py's take_eq variant,
//     probe_pallas_gather2.py::take_eq_kernel and
//     probe_mosaic_gather_forms.py forms f1, f4 and f5.
//   scale        out = a * x, float32 or bfloat16 (float32 product, one
//                rounding). Replaces probe_pallas_gather2.py::trivial_kernel.
//   no-op        an empty kernel: the launch floor that chip_smoke.py times
//                beside the others. It replaces nothing.
//
// What bounds them on this card: bytes. None does arithmetic to speak of
// (the scale one multiply per element); each moves every output byte once
// and reads the rows or elements its indices name. At the largest probe
// shape, B3's flagship level 0 (40 pairs x 122,880 rows of 256 bytes from
// 40 tables of 33,280 rows), a row gather writes 1.26 GB and reads up to
// 341 MB: ~0.48 ms at 3.35 TB/s.
//
// Design: the copies move raw bits, so every form is exact in any dtype of
// its element size. The row gather gives each thread one 16-byte vector
// (or 8, 4, 2 where the row size or a pointer allows no wider), consecutive
// threads on consecutive vectors of a row and then of the next row, so the
// stores coalesce and a row's read is one contiguous run; the block grid is
// (rows / rows per block, pairs), so no thread divides a 64-bit index (nor
// in the take-along: its per-launch count fits 32 bits). A window's rows
// sit in L2 once its first sample has read them; no shared memory staging
// (a W = 1024 window of 256-byte rows is 256 KB, over a block's 227 KB).
// The take-along gives each thread one element of the output. The scale
// gives each thread one unit, a 16-byte vector or one element of the tail
// past the last whole vector (of the whole array, where a pointer is off
// 16-byte alignment), over a grid that covers the array once, and streams
// it through with evict-first loads and stores (ld/st.global.cs): the
// array is read and written once, so nothing of it is worth keeping in L2.
// At a flagship level-0 value (78.6 MB each way in bfloat16, over the
// 50 MB L2) that runs at torch.mul's rate or above; forms that keep 2-8
// loads in flight per thread, over this grid or over a few blocks per SM
// striding across the array, and streaming only the loads or only the
// stores, measured no faster on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum RowMode { kFlat = 0, kSelect = 1, kCopy = 2, kZero = 3 };

template <typename V>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const V* __restrict__ tbl, const int* __restrict__ idx,
                  const int* __restrict__ base, V* __restrict__ out, int R,
                  int S, int nblk, int BS, int W, int unit, int mode, int vpr,
                  int rows_per_block) {
  const int p = blockIdx.y;
  const int lr = threadIdx.x / vpr;
  if (lr >= rows_per_block) return;
  const int s = blockIdx.x * rows_per_block + lr;
  if (s >= S) return;
  const int64_t row = (int64_t)p * S + s;
  int64_t r = -1;
  if (mode == kFlat) {
    r = idx[row];
  } else if (mode == kSelect) {
    const int l = idx[row];
    if (l >= 0 && l < W) r = (int64_t)unit * base[p * nblk + s / BS] + l;
  } else if (mode == kCopy) {
    const int b = s / BS;
    r = (int64_t)unit * base[p * nblk + b] + (s - b * BS);
  }
  const bool ok = r >= 0 && r < R;
  const V* src = tbl + ((int64_t)p * R + (ok ? r : 0)) * vpr;
  V* dst = out + row * vpr;
  // vpr > kThreads (rows over 4 KB): one row per block, a strided loop
  for (int v = threadIdx.x - lr * vpr; v < vpr; v += kThreads) {
    V val = V();
    if (ok) val = src[v];
    dst[v] = val;
  }
}

// total < 2^31 (the C interface checks), so the indices stay 32-bit
template <typename E>
__global__ void __launch_bounds__(kThreads)
take_along_kernel(const E* __restrict__ tbl, const int* __restrict__ idx,
                  E* __restrict__ out, int tbl_rows, int tbl_cols, int C,
                  int axis, int total) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int row = i / C;
  const int col = i - row * C;
  const int k = idx[i];
  E val = E();
  if (axis == 0) {
    if (k >= 0 && k < tbl_rows) val = tbl[(int64_t)k * tbl_cols + col];
  } else {
    if (k >= 0 && k < tbl_cols) val = tbl[(int64_t)row * tbl_cols + k];
  }
  out[i] = val;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// thread u scales unit u: units [0, nvec) are 16-byte vectors, units
// [nvec, units) the tail's elements, one each
template <typename T>
__global__ void __launch_bounds__(kThreads)
scale_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t nvec,
             int64_t units, float a) {
  constexpr int kPer = 16 / sizeof(T);
  const int64_t u = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (u < nvec) {
    uint4 raw = __ldcs(reinterpret_cast<const uint4*>(x) + u);
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < kPer; ++j) from_f(e + j, a * to_f(e[j]));
    __stcs(reinterpret_cast<uint4*>(out) + u, raw);
  } else if (u < units) {
    const int64_t i = nvec * kPer + (u - nvec);
    from_f(out + i, a * to_f(x[i]));
  }
}

__global__ void noop_kernel() {}

bool aligned(const void* p, int64_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// the widest vector (16, 8, 4 or 2 bytes) that `bytes` and both pointers
// are aligned to; 0 for none
int vector_bytes(int64_t bytes, const void* a, const void* b) {
  for (int vb = 16; vb >= 2; vb /= 2)
    if (bytes % vb == 0 && aligned(a, vb) && aligned(b, vb)) return vb;
  return 0;
}

template <typename V>
int launch_row_gather(const void* tbl, const int* idx, const int* base,
                      void* out, int P, int R, int S, int nblk, int BS, int W,
                      int unit, int mode, int vpr, cudaStream_t stream) {
  const int rpb = vpr >= kThreads ? 1 : kThreads / vpr;
  const dim3 grid((unsigned)((S + rpb - 1) / rpb), (unsigned)P);
  row_gather_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(tbl), idx, base, static_cast<V*>(out), R, S,
      nblk, BS, W, unit, mode, vpr, rpb);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes. Each returns the cudaError_t of the launch;
// -1 for arguments the kernel does not take.

// tbl (P, R, row_bytes / esize) contiguous; out (P, S, ...) contiguous;
// mode 0: idx (P, S) int32 rows; modes 1-3: blocks of BS = S / nblk samples,
// base (P, nblk) int32 window origins in units of `unit` rows, idx (P, S)
// int32 window offsets (mode 1 only).
extern "C" int mvg_row_gather(const void* tbl, const void* idx,
                              const void* base, void* out, int P, int R,
                              int S, int nblk, int W, int unit, int mode,
                              int row_bytes, void* stream) {
  if (P < 0 || P > 65535 || R < 1 || S < 0 || row_bytes < 2 || mode < 0 ||
      mode > kZero)
    return -1;
  int BS = 1;
  if (mode != kFlat) {
    if (nblk < 1 || S % nblk != 0 || W < 1) return -1;
    BS = S / nblk;
    if (mode == kCopy && BS > W) return -1;
  }
  if ((int64_t)P * S == 0) return (int)cudaSuccess;
  const int vb = vector_bytes(row_bytes, tbl, out);
  if (vb == 0) return -1;
  const int vpr = row_bytes / vb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  const int* bs = static_cast<const int*>(base);
  switch (vb) {
    case 16:
      return launch_row_gather<uint4>(tbl, ix, bs, out, P, R, S, nblk, BS, W,
                                      unit, mode, vpr, s);
    case 8:
      return launch_row_gather<uint2>(tbl, ix, bs, out, P, R, S, nblk, BS, W,
                                      unit, mode, vpr, s);
    case 4:
      return launch_row_gather<unsigned int>(tbl, ix, bs, out, P, R, S, nblk,
                                             BS, W, unit, mode, vpr, s);
    default:
      return launch_row_gather<unsigned short>(tbl, ix, bs, out, P, R, S,
                                               nblk, BS, W, unit, mode, vpr,
                                               s);
  }
}

// tbl (tbl_rows, tbl_cols), idx and out (S, C), all contiguous; axis 0
// needs C == tbl_cols, axis 1 S == tbl_rows. esize: 2 or 4 bytes.
extern "C" int mvg_take_along(const void* tbl, const void* idx, void* out,
                              int tbl_rows, int tbl_cols, int S, int C,
                              int axis, int esize, void* stream) {
  if (tbl_rows < 1 || tbl_cols < 1 || S < 0 || C < 0 ||
      (axis == 0 && C != tbl_cols) || (axis == 1 && S != tbl_rows) ||
      (axis != 0 && axis != 1))
    return -1;
  const int64_t total = (int64_t)S * C;
  if (total >= INT32_MAX) return -1;
  if (total == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  const int* ix = static_cast<const int*>(idx);
  if (esize == 4) {
    take_along_kernel<unsigned int><<<blocks, kThreads, 0, s>>>(
        static_cast<const unsigned int*>(tbl), ix,
        static_cast<unsigned int*>(out), tbl_rows, tbl_cols, C, axis,
        (int)total);
  } else if (esize == 2) {
    take_along_kernel<unsigned short><<<blocks, kThreads, 0, s>>>(
        static_cast<const unsigned short*>(tbl), ix,
        static_cast<unsigned short*>(out), tbl_rows, tbl_cols, C, axis,
        (int)total);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}

// x and out contiguous, n elements; dtype 0 = float32, 1 = bfloat16. The
// vector path needs both pointers 16-byte aligned, else every element goes
// through the tail path.
extern "C" int mvg_scale(const void* x, void* out, long long n, float a,
                         int dtype, void* stream) {
  if (n < 0 || (dtype != 0 && dtype != 1)) return -1;
  if (n == 0) return (int)cudaSuccess;
  const int per = dtype == 0 ? 4 : 8;
  const int64_t nvec = aligned(x, 16) && aligned(out, 16) ? n / per : 0;
  const int64_t units = nvec + (n - nvec * per);
  const int64_t blocks = (units + kThreads - 1) / kThreads;
  if (blocks > INT32_MAX) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    scale_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), nvec, units,
        a);
  } else {
    scale_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
        nvec, units, a);
  }
  return (int)cudaGetLastError();
}

// One launch of the empty kernel (a block of one warp).
extern "C" int mvg_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
