// Native host-side input pipeline: affine warp + ImageNet normalization.
//
// The port's own copy of mvgformer_tpu/runtime/warp.cpp. The original repo
// warps every view with cv2.warpAffine and normalizes with torchvision
// transforms inside its Python dataloader (lib/dataset/JointsDataset.py:
// 97-116, run/train_3d.py:196-203). Here the per-view crop-warp-normalize
// is one C++ function, multithreaded across views, called via ctypes, so
// the host feeds the card without a Python loop over pixels.
//
// Semantics match cv2.warpAffine(INTER_LINEAR) with the *forward* 2x3
// affine A mapping source->destination: each destination pixel samples the
// source at A^{-1} [x, y, 1] with bilinear interpolation, zero padding
// outside (cv2 default BORDER_CONSTANT 0).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Affine {
  // inverse mapping dst -> src
  double m00, m01, m02, m10, m11, m12;
};

Affine invert(const float *fwd) {
  // fwd is row-major 2x3 (src -> dst); invert the 2x2 + translation
  const double a = fwd[0], b = fwd[1], c = fwd[2];
  const double d = fwd[3], e = fwd[4], f = fwd[5];
  const double det = a * e - b * d;
  const double ia = e / det, ib = -b / det;
  const double id = -d / det, ie = a / det;
  Affine inv;
  inv.m00 = ia;
  inv.m01 = ib;
  inv.m02 = -(ia * c + ib * f);
  inv.m10 = id;
  inv.m11 = ie;
  inv.m12 = -(id * c + ie * f);
  return inv;
}

void warp_rows(const uint8_t *src, int sh, int sw, const Affine &inv,
               float *dst, int dh, int dw, int row_begin, int row_end,
               const float *mean, const float *inv_std) {
  for (int y = row_begin; y < row_end; ++y) {
    float *out_row = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const double sx = inv.m00 * x + inv.m01 * y + inv.m02;
      const double sy = inv.m10 * x + inv.m11 * y + inv.m12;
      const int x0 = static_cast<int>(std::floor(sx));
      const int y0 = static_cast<int>(std::floor(sy));
      const float lx = static_cast<float>(sx - x0);
      const float ly = static_cast<float>(sy - y0);
      float px[3] = {0.f, 0.f, 0.f};
      // bilinear with zero border
      const float w00 = (1 - lx) * (1 - ly), w01 = lx * (1 - ly);
      const float w10 = (1 - lx) * ly, w11 = lx * ly;
      const bool in00 = x0 >= 0 && x0 < sw && y0 >= 0 && y0 < sh;
      const bool in01 = x0 + 1 >= 0 && x0 + 1 < sw && y0 >= 0 && y0 < sh;
      const bool in10 = x0 >= 0 && x0 < sw && y0 + 1 >= 0 && y0 + 1 < sh;
      const bool in11 =
          x0 + 1 >= 0 && x0 + 1 < sw && y0 + 1 >= 0 && y0 + 1 < sh;
      for (int ch = 0; ch < 3; ++ch) {
        float acc = 0.f;
        if (in00)
          acc += w00 * src[(static_cast<size_t>(y0) * sw + x0) * 3 + ch];
        if (in01)
          acc += w01 * src[(static_cast<size_t>(y0) * sw + x0 + 1) * 3 + ch];
        if (in10)
          acc +=
              w10 * src[(static_cast<size_t>(y0 + 1) * sw + x0) * 3 + ch];
        if (in11)
          acc += w11 *
                 src[(static_cast<size_t>(y0 + 1) * sw + x0 + 1) * 3 + ch];
        px[ch] = acc;
      }
      for (int ch = 0; ch < 3; ++ch) {
        out_row[x * 3 + ch] =
            (px[ch] * (1.f / 255.f) - mean[ch]) * inv_std[ch];
      }
    }
  }
}

}  // namespace

extern "C" {

// Warp + normalize a batch of views.
//   src:      V contiguous uint8 HWC RGB images (sh x sw x 3)
//   affines:  V row-major 2x3 forward affines (source -> destination)
//   dst:      V float32 HWC images (dh x dw x 3), normalized
//   mean/std: 3-channel normalization constants
// Returns 0 on success.
int warp_normalize_batch(const uint8_t *src, int num_views, int sh, int sw,
                         const float *affines, float *dst, int dh, int dw,
                         const float *mean, const float *stddev,
                         int num_threads) {
  if (num_threads < 1) num_threads = 1;
  float inv_std[3] = {1.f / stddev[0], 1.f / stddev[1], 1.f / stddev[2]};

  const size_t src_stride = static_cast<size_t>(sh) * sw * 3;
  const size_t dst_stride = static_cast<size_t>(dh) * dw * 3;

  std::vector<std::thread> pool;
  const int total_rows = num_views * dh;
  const int rows_per_thread = (total_rows + num_threads - 1) / num_threads;

  for (int t = 0; t < num_threads; ++t) {
    const int begin = t * rows_per_thread;
    const int end = std::min(total_rows, begin + rows_per_thread);
    if (begin >= end) break;
    pool.emplace_back([=]() {
      for (int gr = begin; gr < end;) {
        const int v = gr / dh;
        const int row = gr % dh;
        const int run = std::min(end - gr, dh - row);
        const Affine inv = invert(affines + static_cast<size_t>(v) * 6);
        warp_rows(src + static_cast<size_t>(v) * src_stride, sh, sw, inv,
                  dst + static_cast<size_t>(v) * dst_stride, dh, dw, row,
                  row + run, mean, inv_std);
        gr += run;
      }
    });
  }
  for (auto &th : pool) th.join();
  return 0;
}
}
