// Corner-table gather-reduce, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel mvgformer_tpu/ops/onehot_gather.py::_onehot_kernel
// (wrappers _onehot_select and deform_gather_reduce) and its backward
// (onehot_gather.py::_bwd, the VJP of the plain gather-reduce). The contract:
//
//   out[p, s, d] = sum_c tables[p, idx[p, s], c*D + d] * w4[p, s, c]
//
// for tables (NH, R, 4D), idx (NH, S) int32, w4 (NH, S, 4), and its VJP
//
//   grad_tables[p, r, c*D + d] = sum_{s: idx[p, s] = r} w4[p, s, c] * ct[p, s, d]
//   grad_w4[p, s, c]           = sum_d tables[p, idx[p, s], c*D + d] * ct[p, s, d]
//
// A row index outside [0, R) reads and writes no table row: its output and
// its grad_w4 are 0.
//
// What bounds it on this card: bytes. At the flagship training shape one
// decoder layer gathers 40 pairs x 122,880 samples per level of one 256-byte
// bf16 row each (1.26 GB of row reads at level 0, from 341 MB of tables,
// over the 50 MB L2); the backward reads the cotangent (64 B per sample) and
// writes every table row once.
//
// Forward: no sort (sorted order does not speed a gather on this card: the
// 40-pair row-gather probe ran 0.92 ms sorted against 0.95 unsorted). Each
// thread makes one 16-byte vector of a sample's output: it reads the four
// corner vectors at the same offset of the row (four independent 16-byte
// loads in flight), weighs them in float32 and stores one vector, so a warp
// covers 8 bf16 samples (D = 32) and its stores are one contiguous run. When
// D * esize is no multiple of 16 bytes or a pointer is not 16-byte aligned
// the wrapper launches the scalar instance (one element per thread).
//
// Backward: the TPU wrapper sorts the samples by row outside its kernel
// (jax.lax.sort_key_val); here the wrapper does the same (a stable
// torch.sort of the key p * (R + 1) + row, out-of-range rows sorting last in
// their pair), which turns the scatter-add into a segmented sum with no
// atomics and no float32 (NH, R, 4D) buffer. Two kernels:
//
//   segment_sum  one warp per tile of `chunk` consecutive sorted samples,
//                staged in shared memory: A, the tile's keys and source
//                samples; B, each sample's cotangent and weights, loaded as
//                16-byte vectors (D * esize / 16 lanes per sample, two
//                rounds of loads in flight), with its grad_w4 computed on
//                the way from the corner vectors of its table row (a
//                shuffle sum over the sample's lanes); C, the walk in sorted
//                order from shared memory, lane l summing channels
//                [l*EPL, (l+1)*EPL) of the row (EPL = D/8), which writes each
//                finished row in the table dtype when all its samples lie
//                in the tile, else as a float32 partial into one of the
//                tile's two slots (0: the row began in an earlier tile, 1:
//                it goes on into a later one).
//   rows         8 lanes per (pair, row): a row with no sample is written as
//                zeros; a row whose samples cross tiles t0 < t1 is the sum
//                of slot 1 of t0 and slot 0 of t0+1 .. t1, in that order.
//
// Every grad_tables row is written once, by one of the two kernels, and every
// sum runs in an order fixed by the stable sort and the tiles, so two
// launches give bit-identical gradients. A hot row (thousands of samples on
// one row, as where people's joints project) costs no more than any other
// run of samples: it is split over as many tiles as it fills, and the tile
// (64 samples) sets the work of a warp whatever the distribution. Each
// phase waits on memory in turn, so the kernel is bound by latency, not by
// bytes: its time scales with the samples, not with the rows. When D is not
// 8, 16, 32 or 64, or tables or ct are not 16-byte aligned, the wrapper
// launches the generic instance (EPL = 0: element loads, a lane per sample
// in B, lanes striding over the 4D channels in C, D <= 128).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxPer = 16;  // the generic backward: 4D <= 32 * kMaxPer

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

// N consecutive elements of T (N * sizeof(T) a power of two, the pointer
// aligned to it or to 16 bytes), as float, in loads of up to 16 bytes
template <typename T, int N>
__device__ __forceinline__ void load_n(const T* __restrict__ p,
                                       float (&v)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  constexpr int kPart = kBytes < 16 ? kBytes : 16;
  constexpr int kPer = kPart / (int)sizeof(T);
  using R = typename Raw<kPart>::type;
#pragma unroll
  for (int q = 0; q < kBytes / kPart; ++q) {
    R raw = reinterpret_cast<const R*>(p)[q];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < kPer; ++k) v[q * kPer + k] = to_f(e[k]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_n(T* __restrict__ p,
                                        const float (&v)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  constexpr int kPart = kBytes < 16 ? kBytes : 16;
  constexpr int kPer = kPart / (int)sizeof(T);
  using R = typename Raw<kPart>::type;
#pragma unroll
  for (int q = 0; q < kBytes / kPart; ++q) {
    R raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < kPer; ++k) from_f(e[k], v[q * kPer + k]);
    reinterpret_cast<R*>(p)[q] = raw;
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// thread t of pair blockIdx.y makes outputs [j*N, (j+1)*N) of sample t / vpc,
// j = t % vpc, vpc = D / N vectors per corner
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
gather_reduce_fwd_kernel(const T* __restrict__ tables,
                         const int* __restrict__ idx,
                         const T* __restrict__ w4, T* __restrict__ out, int R,
                         int S, int D) {
  const int vpc = D / N;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int s = t / vpc;
  if (s >= S) return;
  const int j = t - s * vpc;
  const int64_t sample = (int64_t)blockIdx.y * S + s;
  const int r = idx[sample];
  float acc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = 0.f;
  if (r >= 0 && r < R) {
    const T* row = tables + ((int64_t)blockIdx.y * R + r) * 4 * D + j * N;
    float v[4][N];
#pragma unroll
    for (int c = 0; c < 4; ++c) load_n<T, N>(row + c * D, v[c]);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float wc = to_f(w4[sample * 4 + c]);
#pragma unroll
      for (int k = 0; k < N; ++k) acc[k] += wc * v[c][k];
    }
  }
  store_n<T, N>(out + sample * D + j * N, acc);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// segment_sum: one warp per tile of `chunk` sorted samples (chunk % 4 == 0),
// staged in shared memory in three passes:
//   A  the tile's keys and source samples (chunk / 32 loads per lane);
//   B  every sample's cotangent row and weights into shared memory, with
//      its grad_w4 on the way: VPS = D * esize / 16 lanes per sample, lane j
//      loads the j-th 16-byte vector of the cotangent and of each corner of
//      the table row, the four dots summed over the VPS lanes (EPL > 0; the
//      generic instance: a lane per sample, element by element). Two
//      rounds of loads are issued before any is used;
//   C  the walk in sorted order from shared memory: lane l sums channels
//      [l*EPL, (l+1)*EPL) of the current row (corner l / 8; the generic
//      instance: l + 32 * i), and on a row change writes the finished row:
//      in the table dtype when all its samples lie in this tile, else as a
//      float32 partial into the tile's slot 0 (the row began in an earlier
//      tile) or 1 (it goes on into a later one).
template <typename T, int EPL>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ tables, const T* __restrict__ w4,
                   const T* __restrict__ ct, const int* __restrict__ keys,
                   const int64_t* __restrict__ perm,
                   float* __restrict__ partials, T* __restrict__ grad_tables,
                   T* __restrict__ grad_w4, int R, int D, int64_t total,
                   int chunk) {
  constexpr int kN = EPL > 0 ? EPL : kMaxPer;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t tile = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  const int64_t pos0 = tile * chunk;
  if (pos0 >= total) return;  // the whole warp
  const int n = (int)min((int64_t)chunk, total - pos0);
  const int C = 4 * D;
  // the keys just outside the tile (a row equal to one crosses it), read
  // now so that they are in flight before the first row is written
  const int key_before = pos0 > 0 ? keys[pos0 - 1] : -1;
  const int key_after = pos0 + n < total ? keys[pos0 + n] : -1;
  int* s_key = reinterpret_cast<int*>(
      smem + (size_t)warp * chunk * (28 + D * sizeof(T)));
  int* s_row = s_key + chunk;  // flat row p * R + r, -1 off the table
  int* s_src = s_row + chunk;  // flat sample p * S + s
  float* s_w = reinterpret_cast<float*>(s_src + chunk);  // (chunk, 4)
  T* s_ct = reinterpret_cast<T*>(s_w + 4 * chunk);       // (chunk, D)

  // A
  for (int i = lane; i < n; i += 32) {
    const int k = keys[pos0 + i];
    const int p = k / (R + 1);
    const int r = k - p * (R + 1);
    s_key[i] = k;
    s_row[i] = r < R ? p * R + r : -1;
    s_src[i] = (int)perm[pos0 + i];
  }
  __syncwarp();

  // B
  if constexpr (EPL > 0) {
    constexpr int kV = 16 / sizeof(T);  // elements per vector
    const int vps = D / kV;             // a power of two, <= 16
    const int spi = 32 / vps;           // samples per round
    const int j = lane & (vps - 1);
    constexpr int kRounds = 2;
    for (int i0 = 0; i0 < n; i0 += kRounds * spi) {
      uint4 g[kRounds], t[kRounds][4];
      int row[kRounds], src[kRounds];
#pragma unroll
      for (int u = 0; u < kRounds; ++u) {
        const int i = i0 + u * spi + lane / vps;
        row[u] = i < n ? s_row[i] : -1;
        src[u] = i < n ? s_src[i] : 0;
        if (row[u] >= 0) {
          g[u] = reinterpret_cast<const uint4*>(ct + (int64_t)src[u] * D)[j];
          const uint4* tr = reinterpret_cast<const uint4*>(
              tables + (int64_t)row[u] * C);
#pragma unroll
          for (int c = 0; c < 4; ++c) t[u][c] = tr[c * vps + j];
        }
      }
#pragma unroll
      for (int u = 0; u < kRounds; ++u) {
        const int i = i0 + u * spi + lane / vps;
        float dot[4] = {0.f, 0.f, 0.f, 0.f};
        if (row[u] >= 0) {
          reinterpret_cast<uint4*>(s_ct + i * D)[j] = g[u];
          const T* ge = reinterpret_cast<const T*>(&g[u]);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const T* te = reinterpret_cast<const T*>(&t[u][c]);
#pragma unroll
            for (int k = 0; k < kV; ++k) dot[c] += to_f(te[k]) * to_f(ge[k]);
          }
          if (j == 0) {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              s_w[i * 4 + c] = to_f(w4[(int64_t)src[u] * 4 + c]);
          }
        }
        for (int off = vps / 2; off > 0; off >>= 1) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            dot[c] += __shfl_xor_sync(kFull, dot[c], off);
        }
        if (i < n && j == 0)
          store_n<T, 4>(grad_w4 + (int64_t)src[u] * 4, dot);
      }
    }
  } else {
    for (int i = lane; i < n; i += 32) {
      const int row = s_row[i];
      const int64_t src = s_src[i];
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
      if (row >= 0) {
        const T* tr = tables + (int64_t)row * C;
        for (int d = 0; d < D; ++d) {
          const T gv = ct[src * D + d];
          s_ct[i * D + d] = gv;
#pragma unroll
          for (int c = 0; c < 4; ++c) dot[c] += to_f(tr[c * D + d]) * to_f(gv);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) s_w[i * 4 + c] = to_f(w4[src * 4 + c]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) from_f(grad_w4[src * 4 + c], dot[c]);
    }
  }
  __syncwarp();

  // C
  auto at = [&](int i) { return EPL > 0 ? lane * EPL + i : lane + 32 * i; };
  float acc[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) acc[i] = 0.f;
  int cur = -1, cur_row = -1;
  auto flush = [&]() {
    if (cur_row < 0) return;
    const bool before = cur == key_before, after = cur == key_after;
    if (!before && !after) {
      T* row = grad_tables + (int64_t)cur_row * C;
      if constexpr (EPL > 0) {
        store_n<T, EPL>(row + lane * EPL, acc);
      } else {
#pragma unroll
        for (int i = 0; i < kN; ++i)
          if (at(i) < C) from_f(row[at(i)], acc[i]);
      }
    } else {
      float* row = partials + (tile * 2 + (before ? 0 : 1)) * C;
#pragma unroll
      for (int i = 0; i < kN; ++i)
        if (at(i) < C) row[at(i)] = acc[i];
    }
  };
  // samples read from shared memory 4 at a time before any is summed
  constexpr int kAhead = EPL > 0 ? 4 : 1;
  for (int i0 = 0; i0 < n; i0 += kAhead) {
    int key[kAhead], row[kAhead];
    float wc[kAhead], g[kAhead][kN];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int i = i0 + u;
      key[u] = i < n ? s_key[i] : -2;
      row[u] = i < n ? s_row[i] : -1;
      if (row[u] < 0) continue;  // its weights and cotangent were not staged
      if constexpr (EPL > 0) {
        wc[u] = s_w[i * 4 + (lane >> 3)];
        load_n<T, EPL>(s_ct + i * D + (lane & 7) * EPL, g[u]);
      } else {
#pragma unroll
        for (int m = 0; m < kN; ++m) {
          const int c = at(m) / D;
          g[u][m] = at(m) < C ? s_w[i * 4 + c] * to_f(
              s_ct[i * D + at(m) - c * D]) : 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (key[u] == -2) break;
      if (key[u] != cur) {
        flush();
        cur = key[u];
        cur_row = row[u];
#pragma unroll
        for (int m = 0; m < kN; ++m) acc[m] = 0.f;
      }
      if (cur_row < 0) continue;
#pragma unroll
      for (int m = 0; m < kN; ++m)
        acc[m] += EPL > 0 ? wc[u] * g[u][m] : g[u][m];
    }
  }
  flush();
}

// the shared memory of one warp of segment_sum
size_t segment_bytes(int chunk, int D, int esize) {
  return (size_t)chunk * (28 + (size_t)D * esize);
}

// rows: 8 lanes per (pair, row), 4 rows per warp; lane q over channels
// [q*4*EPL, (q+1)*4*EPL) of the 4D row (EPL > 0), or q + 8 * i (EPL = 0)
template <typename T, int EPL>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const int* __restrict__ offsets, const float* __restrict__ partials,
            T* __restrict__ grad_tables, int NH, int R, int D, int chunk) {
  constexpr int kN = EPL > 0 ? 4 * EPL : 4 * kMaxPer;
  const int64_t w = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 3;
  if (w >= (int64_t)NH * R) return;
  const int q = threadIdx.x & 7;
  const int p = (int)(w / R);
  const int64_t key = w + p;  // p * (R + 1) + r
  const int start = offsets[key], end = offsets[key + 1];
  const int C = 4 * D;
  float acc[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) acc[i] = 0.f;
  auto at = [&](int i) { return EPL > 0 ? q * kN + i : q + 8 * i; };
  if (end > start) {
    const int t0 = start / chunk, t1 = (end - 1) / chunk;
    if (t0 == t1) return;  // written by segment_sum
    for (int t = t0; t <= t1; ++t) {
      // slot 1 of the first tile, slot 0 of the others
      const float* part = partials + ((int64_t)t * 2 + (t == t0)) * C;
#pragma unroll
      for (int i = 0; i < kN; ++i)
        if (at(i) < C) acc[i] += part[at(i)];
    }
  }
  T* row = grad_tables + w * C;
  if constexpr (EPL > 0) {
    store_n<T, kN>(row + q * kN, acc);
  } else {
#pragma unroll
    for (int i = 0; i < kN; ++i)
      if (at(i) < C) from_f(row[at(i)], acc[i]);
  }
}

// the thread width: N elements of 16 bytes, or 1 (the scalar instance)
template <typename T>
bool vector_width(int vec, int D, int* N) {
  *N = vec / (int)sizeof(T);
  return (*N == 1 || vec == 16) && vec % (int)sizeof(T) == 0 && D % *N == 0;
}

template <typename T>
int launch_forward(const void* tables, const int* idx, const void* w4,
                   void* out, int NH, int R, int S, int D, int vec,
                   cudaStream_t s) {
  int N;
  if (!vector_width<T>(vec, D, &N)) return -1;
  const int64_t threads = (int64_t)S * (D / N);
  if (threads > INT32_MAX - kThreads) return -1;
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads), NH);
  const T* t = static_cast<const T*>(tables);
  const T* w = static_cast<const T*>(w4);
  T* o = static_cast<T*>(out);
  if (N == 1) {
    gather_reduce_fwd_kernel<T, 1><<<grid, kThreads, 0, s>>>(t, idx, w, o, R,
                                                             S, D);
  } else {
    gather_reduce_fwd_kernel<T, (int)(16 / sizeof(T))>
        <<<grid, kThreads, 0, s>>>(t, idx, w, o, R, S, D);
  }
  return (int)cudaGetLastError();
}

template <typename T, int EPL>
int launch_segments(const void* tables, const void* w4, const void* ct,
                    const int* keys, const int64_t* perm, const int* offsets,
                    float* partials, void* grad_tables, void* grad_w4, int NH,
                    int R, int S, int D, int chunk, cudaStream_t s) {
  const int64_t total = (int64_t)NH * S;
  if (total > 0) {
    const int64_t tiles = (total + chunk - 1) / chunk;
    const size_t per_warp = segment_bytes(chunk, D, sizeof(T));
    const int warps = (int)std::min<size_t>(
        kWarps, std::max<size_t>(1, (200 * 1024) / per_warp));
    const size_t bytes = per_warp * warps;
    if (bytes > 227 * 1024) return -1;
    if (bytes > 48 * 1024) {
      const int err = (int)cudaFuncSetAttribute(
          segment_sum_kernel<T, EPL>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != 0) return err;
    }
    segment_sum_kernel<T, EPL>
        <<<(unsigned)((tiles + warps - 1) / warps), warps * 32, bytes, s>>>(
            static_cast<const T*>(tables), static_cast<const T*>(w4),
            static_cast<const T*>(ct), keys, perm, partials,
            static_cast<T*>(grad_tables), static_cast<T*>(grad_w4), R, D,
            total, chunk);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const int64_t rows = (int64_t)NH * R;
  constexpr int kRowsPerBlock = kThreads / 8;
  rows_kernel<T, EPL>
      <<<(unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock), kThreads, 0,
         s>>>(
          offsets, partials, static_cast<T*>(grad_tables), NH, R, D, chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_backward(int epl, const void* tables, const void* w4,
                    const void* ct, const int* keys, const int64_t* perm,
                    const int* offsets, float* partials, void* grad_tables,
                    void* grad_w4, int NH, int R, int S, int D, int chunk,
                    cudaStream_t s) {
  if (epl > 0 && D != 8 * epl) return -1;
  if (epl == 0 && 4 * D > 32 * kMaxPer) return -1;
#define MVG_SEGMENTS(E)                                                     \
  return launch_segments<T, E>(tables, w4, ct, keys, perm, offsets,         \
                               partials, grad_tables, grad_w4, NH, R, S, D, \
                               chunk, s)
  switch (epl) {
    case 0: MVG_SEGMENTS(0);
    case 1: MVG_SEGMENTS(1);
    case 2: MVG_SEGMENTS(2);
    case 4: MVG_SEGMENTS(4);
    case 8: MVG_SEGMENTS(8);
    default: return -1;
  }
#undef MVG_SEGMENTS
}

}  // namespace

// C interface, bound with ctypes. tables (NH, R, 4D), w4 (NH, S, 4), out
// (NH, S, D), all contiguous in one dtype: 0 = float32, 1 = bfloat16; idx
// (NH, S) int32. vec: the bytes a thread moves, 16 (D * esize a multiple of
// 16, tables and out 16-byte aligned) or the element size (the scalar
// instance). Returns the cudaError_t of the launch; -1 for arguments the
// kernel does not take.
extern "C" int mvg_table_gather_forward(const void* tables, const void* idx,
                                        const void* w4, void* out, int NH,
                                        int R, int S, int D, int dtype,
                                        int vec, void* stream) {
  if (NH < 0 || NH > 65535 || R < 1 || S < 0 || D < 1) return -1;
  if ((int64_t)NH * S == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  if (dtype == 0)
    return launch_forward<float>(tables, ix, w4, out, NH, R, S, D, vec, s);
  if (dtype == 1)
    return launch_forward<__nv_bfloat16>(tables, ix, w4, out, NH, R, S, D,
                                         vec, s);
  return -1;
}

// The segmented-sum backward. ct (NH, S, D), grad_w4 (NH, S, 4) and
// grad_tables (NH, R, 4D) in the dtype of tables (grad_tables written
// whole: the caller need not clear it); keys (NH*S) int32, the sorted keys
// p * (R + 1) + row (row R for an index off the table); perm (NH*S) int64,
// the flat sample p * S + s at each sorted position; offsets (NH, R + 1)
// int32, where row r of pair p starts among the sorted positions; partials
// float32 (ceil(NH*S / chunk), 2, 4D), scratch; chunk a multiple of 4. epl:
// D / 8 for D in {8, 16, 32, 64} with tables and ct 16-byte aligned, else 0
// (the generic instance, D <= 128).
extern "C" int mvg_table_gather_backward(
    const void* tables, const void* w4, const void* ct, const void* keys,
    const void* perm, const void* offsets, void* partials, void* grad_tables,
    void* grad_w4, int NH, int R, int S, int D, int chunk, int dtype, int epl,
    void* stream) {
  if (NH < 0 || R < 1 || S < 0 || D < 1 || chunk < 4 || chunk % 4 != 0)
    return -1;
  if ((int64_t)NH * (R + 1) >= INT32_MAX || (int64_t)NH * S >= INT32_MAX)
    return -1;
  if ((int64_t)NH * R == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* k = static_cast<const int*>(keys);
  const int64_t* pm = static_cast<const int64_t*>(perm);
  const int* off = static_cast<const int*>(offsets);
  float* part = static_cast<float*>(partials);
  if (dtype == 0)
    return launch_backward<float>(epl, tables, w4, ct, k, pm, off, part,
                                  grad_tables, grad_w4, NH, R, S, D, chunk, s);
  if (dtype == 1)
    return launch_backward<__nv_bfloat16>(epl, tables, w4, ct, k, pm, off,
                                          part, grad_tables, grad_w4, NH, R,
                                          S, D, chunk, s);
  return -1;
}
