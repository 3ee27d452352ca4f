// Point-top-m in ProjAttn, for Hopper (sm_90a): the serving selection of
// the m heaviest of a (query, head, level)'s P sampling points, in one
// launch per decoder layer.
//
// Replaces, for a serving call (no gradient), the plain chain of
// ops/point_topm.py::plain_point_topm:
//
//   idx     = the m largest of the P weights, descending, the lower index
//             first among equal values (a stable descending torch.sort;
//             the rule of jax.lax.top_k in mvgformer_tpu/ops/projattn.py)
//   w_sel   = w[idx]                 locations[idx] in the same order
//   w_out   = w_sel / max(sum of w_sel over (level, kept point), 1e-6)
//
// It replaces no TPU kernel: on the TPU, XLA fuses lax.top_k and the
// gathers. On the card the plain chain is a segmented radix sort of every
// row of P = 8 weights with an int64 index per weight, then gathers, a sum
// and a division: ~6 device ms of a served frame for ~200 MB of work.
//
// What bounds it: bytes. A row's P weights and 2P location floats are read
// once and its m weights and 2m locations written once; no row reads
// another's. One thread owns one (n, q, h): its Lt levels of P weights and
// 2P locations are contiguous (96 and 192 bytes at Lt 3, P 8), loaded as
// float4s, so the warp reads a contiguous span and every sector it fetches
// is used. Ranks are counted, not sorted:
//
//   rank_i = #{j : w_j > w_i} + #{j < i : w_j == w_i}
//
// which is the slot of a stable descending sort; a point is kept where
// rank_i < m and written at slot rank_i. Every index is a compile-time
// constant (P and m are template arguments, each loop unrolled), so the
// selection is register moves and selects with no local memory. NaN ranks
// above every number, as in torch.sort's descending order, so the ranks
// are a permutation whatever the input.
//
// The kept sum runs over the levels and, within a level, over the slots in
// order, accumulated in double and rounded once to float: within one
// float rounding of the exact sum, where the plain chain's torch.sum adds
// in an order of its own. The weights are read twice, once for the sum and
// once for the output, the second time from L1 (a block's 128 rows are 12
// KB of weights). The division is IEEE float32, as torch's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// a stands before b in a stable descending order, a's index being lower
// where `lower`: larger, or equal and first; NaN above every number
__device__ __forceinline__ bool before(float a, float b, bool lower) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || lower);
  return a > b || (lower && a == b);
}

template <int N>
__device__ __forceinline__ void load(float (&v)[N], const float* p) {
  static_assert(N % 4 == 0, "rows of whole float4s");
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p + k));
    v[k] = x.x; v[k + 1] = x.y; v[k + 2] = x.z; v[k + 3] = x.w;
  }
}

// N floats at p, in the widest vectors N and p's alignment (N floats
// times the row index) allow
template <int N>
__device__ __forceinline__ void store(float* p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 4)
      *reinterpret_cast<float4*>(p + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 2)
      *reinterpret_cast<float2*>(p + k) = make_float2(v[k], v[k + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = v[k];
  }
}

template <int P>
__device__ __forceinline__ void ranks(const float (&w)[P], int (&rank)[P]) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    int r = 0;
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (j != i) r += before(w[j], w[i], j < i) ? 1 : 0;
    rank[i] = r;
  }
}

template <int P, int M>
__global__ void __launch_bounds__(kThreads)
point_topm_kernel(const float* __restrict__ w, const float* __restrict__ loc,
                  float* __restrict__ w_out, float* __restrict__ loc_out,
                  int64_t rows, int levels) {
  const int64_t row = blockIdx.x * static_cast<int64_t>(kThreads) +
                      threadIdx.x;
  if (row >= rows) return;
  const float* w_row = w + row * levels * P;

  double kept = 0.0;
  for (int l = 0; l < levels; ++l) {
    float v[P];
    int rank[P];
    load(v, w_row + l * P);
    ranks(v, rank);
#pragma unroll
    for (int s = 0; s < M; ++s) {
      float sel = 0.0f;
#pragma unroll
      for (int i = 0; i < P; ++i) sel = rank[i] == s ? v[i] : sel;
      kept += static_cast<double>(sel);
    }
  }
  float norm = static_cast<float>(kept);
  norm = norm < 1e-6f ? 1e-6f : norm;  // torch.clamp: NaN stays NaN

  const float* loc_row = loc + row * levels * P * 2;
  float* w_dst = w_out + row * levels * M;
  float* loc_dst = loc_out + row * levels * M * 2;
  for (int l = 0; l < levels; ++l) {
    float v[P], xy[2 * P], wo[M], lo[2 * M];
    int rank[P];
    load(v, w_row + l * P);
    load(xy, loc_row + l * P * 2);
    ranks(v, rank);
#pragma unroll
    for (int s = 0; s < M; ++s) {
      wo[s] = 0.0f;
      lo[2 * s] = lo[2 * s + 1] = 0.0f;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const bool hit = rank[i] == s;
        wo[s] = hit ? v[i] : wo[s];
        lo[2 * s] = hit ? xy[2 * i] : lo[2 * s];
        lo[2 * s + 1] = hit ? xy[2 * i + 1] : lo[2 * s + 1];
      }
      wo[s] = wo[s] / norm;
    }
    store(w_dst + l * M, wo);
    store(loc_dst + l * M * 2, lo);
  }
}

template <int P, int M>
int launch(const float* w, const float* loc, float* w_out, float* loc_out,
           int64_t rows, int levels, cudaStream_t stream) {
  const int64_t blocks = (rows + kThreads - 1) / kThreads;
  point_topm_kernel<P, M><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(w, loc, w_out, loc_out, rows, levels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// weights (rows, levels, P) and locations (rows, levels, P, 2), float32,
// contiguous and 16-byte aligned; w_out (rows, levels, m) and loc_out
// (rows, levels, m, 2). Returns the launch's cudaError_t, or -1 for a
// (P, m) with no instance here.
extern "C" int mvg_point_topm(const float* w, const float* loc, float* w_out,
                              float* loc_out, int64_t rows, int levels,
                              int P, int m, void* stream) {
  if (rows <= 0 || levels <= 0) return rows == 0 ? 0 : -1;
  if (rows > static_cast<int64_t>(0x7fffffff) * kThreads) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 8 && m == 4)
    return launch<8, 4>(w, loc, w_out, loc_out, rows, levels, s);
  if (P == 8 && m == 2)
    return launch<8, 2>(w, loc, w_out, loc_out, rows, levels, s);
  return -1;
}
