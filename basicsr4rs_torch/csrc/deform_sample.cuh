// Device code shared by the deformable-sampler kernels (forward and backward).
//
// The sampler reads x (N, C, H, W) at the K = kh * kw tap positions of a
// deformable convolution: for output pixel (ho, wo), deform group g and tap
// k = i * kw + j,
//
//   py = ho * stride - pad + i * dil + offset[n, g * 2K + 2k,     ho, wo]
//   px = wo * stride - pad + j * dil + offset[n, g * 2K + 2k + 1, ho, wo]
//
// and the sample is the bilinear blend of the four pixels around (py, px),
// a pixel outside the map counting as zero, times mask[n, g * K + k, ho, wo]
// where there is a mask. The sample is zero unless -1 < py < H and
// -1 < px < W. The blend is written with y0 = floor(py), ly = py - y0, so
// the derivative in py at a whole number is the one-sided
// v[y0 + 1] - v[y0], and it is zero wherever the sample is.

#pragma once

#include "swin_common.cuh"

namespace dsample {

using swin::from_f32;
using swin::to_f32;

constexpr int kThreads = 256;
constexpr int kChunk = 8;  // channels one thread of the forward or dx kernel walks

struct Geometry {
  int batch, channels, height, width;  // x
  int out_h, out_w;                    // offset, mask and the samples
  int kh, kw, stride, pad, dil;
  int groups;                          // deform groups
};

__host__ __device__ inline int taps(const Geometry& g) { return g.kh * g.kw; }
__host__ __device__ inline int group_channels(const Geometry& g) {
  return g.channels / g.groups;
}
__host__ __device__ inline int chunks(const Geometry& g) {
  return (group_channels(g) + kChunk - 1) / kChunk;
}

inline int blocks_for(long long items) {
  const long long blocks = (items + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < (1LL << 30) ? blocks : (1LL << 30));
}

// One tap of one output pixel: where it falls and how the four pixels blend.
struct Tap {
  bool inside;        // -1 < py < H and -1 < px < W
  int y0, x0;         // floor of the position
  float ly, lx;       // position minus floor
  bool top, bottom, left, right;  // rows y0, y0 + 1 and columns x0, x0 + 1 in the map
  float modulation;   // the mask's value, 1 without a mask
  size_t offset_at;   // index of the tap's dy in offset; dx is out_h * out_w further
  size_t mask_at;     // index of the tap's value in mask
};

__device__ __forceinline__ Tap locate(const Geometry& g, const float* __restrict__ offset,
                                      const float* __restrict__ mask, int n, int grp, int k,
                                      int pixel) {
  const int K = taps(g), P = g.out_h * g.out_w;
  const int ho = pixel / g.out_w, wo = pixel % g.out_w;
  Tap t;
  t.offset_at = (static_cast<size_t>(n * g.groups + grp) * 2 * K + 2 * k) * P + pixel;
  t.mask_at = (static_cast<size_t>(n * g.groups + grp) * K + k) * P + pixel;
  const float py = static_cast<float>(ho * g.stride - g.pad + (k / g.kw) * g.dil) +
                   offset[t.offset_at];
  const float px = static_cast<float>(wo * g.stride - g.pad + (k % g.kw) * g.dil) +
                   offset[t.offset_at + P];
  t.inside = py > -1.f && py < static_cast<float>(g.height) && px > -1.f &&
             px < static_cast<float>(g.width);
  const float fy = floorf(py), fx = floorf(px);
  t.y0 = static_cast<int>(fy);
  t.x0 = static_cast<int>(fx);
  t.ly = py - fy;
  t.lx = px - fx;
  t.top = t.y0 >= 0;                // inside: y0 <= H - 1
  t.bottom = t.y0 + 1 < g.height;   // inside: y0 + 1 >= 0
  t.left = t.x0 >= 0;
  t.right = t.x0 + 1 < g.width;
  t.modulation = mask ? mask[t.mask_at] : 1.f;
  return t;
}

// The four pixels around the tap in one channel's map, zero outside it.
template <typename T>
__device__ __forceinline__ void corners(const T* __restrict__ map, const Geometry& g, const Tap& t,
                                        float& v00, float& v01, float& v10, float& v11) {
  const T* row0 = map + static_cast<ptrdiff_t>(t.y0) * g.width + t.x0;
  const T* row1 = row0 + g.width;
  v00 = (t.top && t.left) ? to_f32(row0[0]) : 0.f;
  v01 = (t.top && t.right) ? to_f32(row0[1]) : 0.f;
  v10 = (t.bottom && t.left) ? to_f32(row1[0]) : 0.f;
  v11 = (t.bottom && t.right) ? to_f32(row1[1]) : 0.f;
}

}  // namespace dsample
