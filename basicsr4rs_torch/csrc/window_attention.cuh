// Device code shared by the window-attention kernels (forward and backward).
//
// One thread block of kThreads threads works on one head of one attention
// window: n = ws * ws <= 64 tokens of hd <= 64 channels each. q, k, v (and
// dO in the backward) are read straight from the (B, H, W, 3C) / (B, H, W, C)
// tensors by window addressing (a head's hd channels of a token are
// contiguous), so no window-partition copy exists. They sit token-major in
// shared memory as float32 with an odd row stride, the n x n scores beside
// them. Every product runs on the CUDA cores and accumulates in float32; a
// value that feeds the second product of a chain (P, dS) is first rounded
// to the model dtype T, as the plain version rounds it.
//
// Two product shapes cover forward and backward:
//   tile_dot      acc(i, j) = sum_d A[i][d] B[j][d]        scores, dP
//   row_product   out(r, d) = sum_m S(r, m) X[m][d]        P v, dS k; with
//                 S read transposed: P^T dO, dS^T q

#pragma once

#include "swin_common.cuh"

namespace wattn {

using swin::from_f32;
using swin::round_to;
using swin::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTokens = 64;   // ws * ws
constexpr int kMaxHeadDim = 64;
constexpr int kTile = 4;         // thread (ty, tx) of the 16 x 16 thread grid owns
                                 // the score entries (ty + 16 a, tx + 16 b), a, b < 4
static_assert(kThreads == 256 && kTile * 16 == kMaxTokens, "16 x 16 threads cover 64 x 64");

struct Geometry {
  int batch, height, width, channels, heads, window;
  int bias_windows;  // leading size of the bias: 1, or the windows of one image
  float scale;
};

// Odd row strides: consecutive rows start in different banks.
__host__ __device__ inline int head_stride(int hd) { return hd | 1; }
__host__ __device__ inline int score_stride(int n) { return n | 1; }

// Offset of the first channel of token t of window `win` of image `img` in
// a (B, H, W, ch) tensor.
__device__ __forceinline__ size_t token_offset(const Geometry& g, int img, int win, int t, int ch) {
  const int nww = g.width / g.window;
  const int row = (win / nww) * g.window + t / g.window;
  const int col = (win % nww) * g.window + t % g.window;
  return ((static_cast<size_t>(img) * g.height + row) * g.width + col) * ch;
}

// X[t][d] = f(src[token t][first + d]) for the window's n tokens and d < hd;
// neighbouring lanes read neighbouring channels.
template <typename T, class F>
__device__ __forceinline__ void load_head(float* X, const T* __restrict__ src, const Geometry& g,
                                          int img, int win, int ch, int first, int n, int hd,
                                          F f) {
  const int ld = head_stride(hd);
  for (int e = threadIdx.x; e < n * hd; e += kThreads) {
    const int t = e / hd, d = e % hd;
    X[t * ld + d] = f(to_f32(src[token_offset(g, img, win, t, ch) + first + d]));
  }
}

// acc[a][b] = sum_d A[i_a][d] * B[j_b][d] for this thread's entries
// i_a = ty + 16 a, j_b = tx + 16 b (rows beyond n are clamped; the caller
// ignores them).
__device__ __forceinline__ void tile_dot(const float* __restrict__ A, const float* __restrict__ B,
                                         int n, int hd, float (&acc)[kTile][kTile]) {
  const int ld = head_stride(hd);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int tiles = (n + 15) / 16;
  const float* ap[kTile];
  const float* bp[kTile];
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
    ap[a] = A + min(ty + 16 * a, n - 1) * ld;
    bp[a] = B + min(tx + 16 * a, n - 1) * ld;
#pragma unroll
    for (int b = 0; b < kTile; ++b) acc[a][b] = 0.f;
  }
  for (int d = 0; d < hd; ++d) {
    float av[kTile], bv[kTile];
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
      av[a] = ap[a][d];
      bv[a] = bp[a][d];
    }
#pragma unroll
    for (int a = 0; a < kTile; ++a)
#pragma unroll
      for (int b = 0; b < kTile; ++b)
        if (a < tiles && b < tiles) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
  }
}

// S[i][j] = acc(i, j) + bias[i][j] for this thread's entries with i, j < n.
__device__ __forceinline__ void store_scores(float* S, const float (&acc)[kTile][kTile],
                                             const float* __restrict__ bias, int n) {
  const int lds = score_stride(n);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < kTile; ++a)
#pragma unroll
    for (int b = 0; b < kTile; ++b) {
      const int i = ty + 16 * a, j = tx + 16 * b;
      if (i < n && j < n) S[i * lds + j] = acc[a][b] + bias[i * n + j];
    }
}

// Softmax over the n keys of each of the n query rows of S, one warp per
// row, two keys per lane; float32, not rounded.
__device__ __forceinline__ void softmax_rows(float* S, int n) {
  const int lds = score_stride(n), lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < n; i += kWarps) {
    float* row = S + i * lds;
    const bool in0 = lane < n, in1 = lane + 32 < n;
    const float v0 = in0 ? row[lane] : -INFINITY;
    const float v1 = in1 ? row[lane + 32] : -INFINITY;
    float m = fmaxf(v0, v1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float e0 = in0 ? expf(v0 - m) : 0.f;
    const float e1 = in1 ? expf(v1 - m) : 0.f;
    float s = e0 + e1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (in0) row[lane] = e0 / s;
    if (in1) row[lane + 32] = e1 / s;
  }
}

// out(r, d) = sum_m round_T(S(r, m)) * X[m][d] for r < n, d < hd, m < n, with
// S(r, m) = S[r][m], or S[m][r] when kTransposed. A thread owns four rows r
// of one column d: lanes along d, so X is read without bank conflicts, S as
// broadcasts, and epi(r, d, v) can write device memory whose fastest index
// is d.
template <typename T, bool kTransposed, class Epi>
__device__ __forceinline__ void row_product(const float* __restrict__ S,
                                            const float* __restrict__ X, int n, int hd, Epi epi) {
  const int lds = score_stride(n), ld = head_stride(hd);
  const int groups = (n + 3) / 4;
  for (int e = threadIdx.x; e < groups * hd; e += kThreads) {
    const int r0 = (e / hd) * 4, d = e % hd;
    int r[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) r[a] = min(r0 + a, n - 1);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int m = 0; m < n; ++m) {
      const float x = X[m * ld + d];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float s = kTransposed ? S[m * lds + r[a]] : S[r[a] * lds + m];
        acc[a] = fmaf(round_to<T>(s), x, acc[a]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
      if (r0 + a < n) epi(r0 + a, d, acc[a]);
  }
}

}  // namespace wattn
