// Device code shared by the deformable-sampler kernels (forward and backward).
//
// The sampler reads x (N, C, H, W) at the K = kh * kw tap positions of a
// deformable convolution: for output pixel (ho, wo), deform group g and tap
// k = i * kw + j,
//
//   py = ho * stride - pad + i * dil + dy[n, g, k, ho, wo]
//   px = wo * stride - pad + j * dil + dx[n, g, k, ho, wo]
//
// and the sample is the bilinear blend of the four pixels around (py, px),
// a pixel outside the map counting as zero, times mask[n, g * K + k, ho, wo]
// where there is a mask. The sample is zero unless -1 < py < H and
// -1 < px < W. The blend is written with y0 = floor(py), ly = py - y0, so
// the derivative in py at a whole number is the one-sided
// v[y0 + 1] - v[y0], and it is zero wherever the sample is.
//
// The offsets are read through strides (OffsetLayout): the (dy, dx) pair of
// sample n, deform group g, tap k and output pixel p = ho * Wo + wo has dy
// at start + n * batch + (g * K + k) * tap + p * pixel and dx `pair`
// elements from it. BasicSR's offset (N, G * 2K, Ho, Wo) is (0, G * 2K * P,
// 2P, P, 1); a flow (N, H, W, 2) with last dimension (dx, dy), in any
// strides whose pixels flatten, is (s_c, s_n, 0, -s_c, s_w).

#pragma once

#include "swin_common.cuh"

namespace dsample {

using swin::from_f32;
using swin::to_f32;

constexpr int kThreads = 256;
constexpr int kChunk = 8;  // channels one thread of the forward walks at once

struct Geometry {
  int batch, channels, height, width;  // x
  int out_h, out_w;                    // offset, mask and the samples
  int kh, kw, stride, pad, dil;
  int groups;                          // deform groups
};

struct OffsetLayout {
  int start, batch, tap, pair, pixel;   // in float32 elements
};

__host__ __device__ inline int taps(const Geometry& g) { return g.kh * g.kw; }
__host__ __device__ inline int group_channels(const Geometry& g) {
  return g.channels / g.groups;
}
__host__ __device__ inline int chunks(const Geometry& g) {
  return (group_channels(g) + kChunk - 1) / kChunk;
}

}  // namespace dsample
