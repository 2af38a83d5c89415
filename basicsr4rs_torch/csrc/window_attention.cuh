// Device code of the window-attention kernels: the geometry and window
// addressing both use, and the forward's (window_attention_fwd.cu) body on
// the CUDA cores. The backward (window_attention_bwd.cu) runs its products
// on the tensor cores over branch_bwd.cuh's fragments.
//
// The forward: one thread block of kThreads threads works on one head of one
// attention window: n = ws * ws <= kMaxTokens tokens of hd <= 64 channels
// each. q, k, v are read straight from the (B, H, W, 3C) tensor by window
// addressing (a head's hd channels of a token are contiguous), so no
// window-partition copy exists. They sit token-major in shared memory as
// float32 with an odd row stride, the n x n scores beside them. Every
// product runs on the CUDA cores and accumulates in float32; P is first
// rounded to the model dtype T, as the plain version rounds it.
//
// Two product shapes:
//   tile_dot      acc(i, j) = sum_d A[i][d] B[j][d]        scores
//   row_product   out(r, d) = sum_m S(r, m) X[m][d]        P v
// A thread (ty, tx) of the 16 x 16 thread grid owns the score entries
// (ty + 16 a, tx + 16 b), a, b < kTile: kTile = 4 covers 64 tokens, 6 covers
// 96 (window 9's 81).

#pragma once

#include "swin_common.cuh"

namespace wattn {

using swin::from_f32;
using swin::round_to;
using swin::to_f32;

constexpr int kThreads = 256;   // the forward's 16 x 16 thread grid
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTokens = 96;   // ws * ws, both kernels
constexpr int kMaxHeadDim = 64;

// score entries a thread of the forward owns along each side: 4 up to 64
// tokens, 6 up to 96
__host__ __device__ constexpr int tile_of(int n) { return n <= 64 ? 4 : 6; }

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
template <int kTile>
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
template <int kTile>
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
// row, kKeys keys per lane (2 up to 64 tokens, 3 up to 96); float32, not
// rounded.
template <int kKeys>
__device__ __forceinline__ void softmax_rows(float* S, int n) {
  const int lds = score_stride(n), lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < n; i += kWarps) {
    float* row = S + i * lds;
    float v[kKeys], m = -INFINITY;
#pragma unroll
    for (int k = 0; k < kKeys; ++k) {
      v[k] = lane + 32 * k < n ? row[lane + 32 * k] : -INFINITY;
      m = fmaxf(m, v[k]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kKeys; ++k) {
      v[k] = lane + 32 * k < n ? expf(v[k] - m) : 0.f;
      s += v[k];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
#pragma unroll
    for (int k = 0; k < kKeys; ++k)
      if (lane + 32 * k < n) row[lane + 32 * k] = v[k] / s;
  }
}

// out(r, d) = sum_m round_T(S[r][m]) * X[m][d] for r < n, d < hd, m < n. A
// thread owns four rows r of one column d: lanes along d, so X is read
// without bank conflicts, S as broadcasts, and epi(r, d, v) can write device
// memory whose fastest index is d.
template <typename T, class Epi>
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
        acc[a] = fmaf(round_to<T>(S[r[a] * lds + m]), x, acc[a]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
      if (r0 + a < n) epi(r0 + a, d, acc[a]);
  }
}

}  // namespace wattn
