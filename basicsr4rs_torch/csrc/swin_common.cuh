// Device code shared by the Swin block kernels (the joint forward, the split
// attention and MLP branches, and their backward kernels).
//
// One thread block of kThreads threads works on a tile of at most kTok
// tokens (one attention window, or kTok consecutive tokens of the MLP).
// Activations sit feature-major in shared memory, one row of kTok floats
// per feature (row stride kLd), so lane l of a warp owns tokens 2l and 2l+1
// and reads them as one float2. Every buffer is float32; a value that feeds
// a GEMM is first rounded to the model dtype T (float32 or bfloat16), and
// every GEMM accumulates in float32. Weights keep the nn.Linear (out, in)
// layout in device memory and stream through two shared-memory stages by
// cp.async.
//
// Three GEMM shapes cover forward and backward:
//   gemm_w    out(o, t) = sum_k A[k][t] W[o][k]     y = x W^T     (weight rows)
//   gemm_wt   out(o, t) = sum_k A[k][t] W[k][o]     dx = dy W     (weight columns)
//   gemm_tok  out(a, b) = sum_t A[a][t] B[b][t]     dW = dy^T x   (over the tokens)
// and gemm_s is gemm_w with the second operand in shared memory. gemm_w_i8 is
// gemm_w on int8 operands (int32 sums by __dp4a), fed by quantize_tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace swin {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTok = 64;        // tokens per tile, padded; ws * ws <= kTok
constexpr int kLd = kTok + 2;   // row stride: even for float2, 2-way banks on transposes
constexpr int kHidChunk = 96;   // MLP hidden columns per chunk (multiple of 4)
constexpr int kTN = 6;          // weight GEMMs: output columns per warp and round
constexpr int kRoundRows = kWarps * kTN;  // weight rows staged per round
constexpr int kKTile = 32;      // weight GEMMs: K elements per pipeline stage
constexpr int kStageElems = 2 * kRoundRows * kKTile;  // both stages, in elements
constexpr int kKTileI8 = 4 * kKTile;  // int8 weight GEMMs: K bytes per stage, the same stage bytes
constexpr int kPerTok = kThreads / kTok;  // threads per token in LayerNorm and softmax
static_assert(kPerTok == 8, "the token reductions below use 8 lanes");

// What a branch kernel writes: the branch z, z + x, or s[sample] * z + x.
enum Mode { kBranch = 0, kResidual = 1, kScaled = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The model dtype's rounding of a value that feeds a GEMM.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// cp.async of N elements (16, 8 or 4 bytes) into shared memory
template <int N, typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  constexpr int kBytes = N * sizeof(T);
  static_assert(kBytes == 16 || kBytes == 8 || kBytes == 4, "cp.async size");
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else if constexpr (kBytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Four consecutive staged weights in shared memory as floats.
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// Two consecutive staged weights as floats.
__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 lds2(const __nv_bfloat16* p) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// acc * d, kept a multiplication of its own (no fused multiply-add with the
// bias that follows), as the plain version computes it.
__device__ __forceinline__ float dequant(int acc, float d) {
  return __fmul_rn(static_cast<float>(acc), d);
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
}

// d gelu(v) / dv for the exact (erf) GELU
__device__ __forceinline__ float gelu_grad(float v) {
  const float cdf = 0.5f * (1.f + erff(v * 0.7071067811865476f));
  const float pdf = expf(-0.5f * v * v) * 0.3989422804014327f;
  return cdf + v * pdf;
}

// out(o, t) = sum_k A[k][t] * W_o[k] over the kTok token columns of the
// feature-major shared operand A and the global weight rows W_o = row(o)
// (K % 4 == 0). The output rows go in rounds of kRoundRows; in each round
// the whole block streams the round's weights through two shared-memory
// stages of kKTile columns with cp.async, and warp w owns rows w * kTN ...
// of the round. epi(o, t, v_t, v_t+1) receives two tokens at once.
template <typename T, class Row, class Epi>
__device__ __forceinline__ void gemm_w(const float* __restrict__ A, int K, int N, Row row, Epi epi,
                                       T* stages) {
  const int t = 2 * (threadIdx.x & 31);
  const int o0 = (threadIdx.x >> 5) * kTN;  // this warp's first row in a round
  for (int r0 = 0; r0 < N; r0 += kRoundRows) {
    const int rows = min(kRoundRows, N - r0);
    auto stage_in = [&](int s, int k0) {
      const int chunks = min(kKTile, K - k0) / 4;
      for (int c = threadIdx.x; c < rows * chunks; c += kThreads) {
        const int o = c / chunks, q = c % chunks;
        cp_async<4>(stages + (s * kRoundRows + o) * kKTile + 4 * q, row(r0 + o) + k0 + 4 * q);
      }
      cp_async_commit();
    };
    float acc0[kTN], acc1[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      acc0[j] = 0.f;
      acc1[j] = 0.f;
    }
    stage_in(0, 0);
    for (int k0 = 0, s = 0; k0 < K; k0 += kKTile, s ^= 1) {
      if (k0 + kKTile < K) {
        stage_in(s ^ 1, k0 + kKTile);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* w = stages + (s * kRoundRows + o0) * kKTile;
      const int kn = min(kKTile, K - k0);
      for (int kk = 0; kk < kn; kk += 4) {
        const float* a = A + (k0 + kk) * kLd + t;
        const float2 a0 = *reinterpret_cast<const float2*>(a);
        const float2 a1 = *reinterpret_cast<const float2*>(a + kLd);
        const float2 a2 = *reinterpret_cast<const float2*>(a + 2 * kLd);
        const float2 a3 = *reinterpret_cast<const float2*>(a + 3 * kLd);
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const float4 b = lds4(w + j * kKTile + kk);
          acc0[j] = fmaf(a0.x, b.x, acc0[j]);
          acc1[j] = fmaf(a0.y, b.x, acc1[j]);
          acc0[j] = fmaf(a1.x, b.y, acc0[j]);
          acc1[j] = fmaf(a1.y, b.y, acc1[j]);
          acc0[j] = fmaf(a2.x, b.z, acc0[j]);
          acc1[j] = fmaf(a2.y, b.z, acc1[j]);
          acc0[j] = fmaf(a3.x, b.w, acc0[j]);
          acc1[j] = fmaf(a3.y, b.w, acc1[j]);
        }
      }
      __syncthreads();  // the stage is refilled next
    }
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      if (o0 + j < rows) epi(r0 + o0 + j, t, acc0[j], acc1[j]);
  }
}

// out(o, t) = sum_k A[k][t] * W_k[o]: the product with the transpose of a
// weight, read in place. row(k) points at the N consecutive elements of the
// k-th reduction row (global, aligned to CH elements; N % CH == 0, CH 4 or
// 2). A stage holds kKTile reduction rows of kRoundRows outputs; warp w
// reads its kTN outputs of a row as three pairs.
template <typename T, int CH, class Row, class Epi>
__device__ __forceinline__ void gemm_wt(const float* __restrict__ A, int K, int N, Row row, Epi epi,
                                        T* stages) {
  static_assert(kTN == 6, "three pairs of outputs per warp");
  const int t = 2 * (threadIdx.x & 31);
  const int o0 = (threadIdx.x >> 5) * kTN;
  for (int r0 = 0; r0 < N; r0 += kRoundRows) {
    const int rows = min(kRoundRows, N - r0);
    auto stage_in = [&](int s, int k0) {
      const int kn = min(kKTile, K - k0);
      const int chunks = rows / CH;
      for (int c = threadIdx.x; c < kn * chunks; c += kThreads) {
        const int k = c / chunks, q = c % chunks;
        cp_async<CH>(stages + (s * kKTile + k) * kRoundRows + CH * q, row(k0 + k) + r0 + CH * q);
      }
      cp_async_commit();
    };
    float acc0[kTN], acc1[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      acc0[j] = 0.f;
      acc1[j] = 0.f;
    }
    stage_in(0, 0);
    for (int k0 = 0, s = 0; k0 < K; k0 += kKTile, s ^= 1) {
      if (k0 + kKTile < K) {
        stage_in(s ^ 1, k0 + kKTile);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* w = stages + s * kKTile * kRoundRows + o0;
      const int kn = min(kKTile, K - k0);
      for (int kk = 0; kk < kn; ++kk) {
        const float2 a = *reinterpret_cast<const float2*>(A + (k0 + kk) * kLd + t);
        const T* wk = w + kk * kRoundRows;
        const float2 b01 = lds2(wk), b23 = lds2(wk + 2), b45 = lds2(wk + 4);
        const float b[kTN] = {b01.x, b01.y, b23.x, b23.y, b45.x, b45.y};
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          acc0[j] = fmaf(a.x, b[j], acc0[j]);
          acc1[j] = fmaf(a.y, b[j], acc1[j]);
        }
      }
      __syncthreads();  // the stage is refilled next
    }
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      if (o0 + j < rows) epi(r0 + o0 + j, t, acc0[j], acc1[j]);
  }
}

// gemm_w on int8 operands: out(o, t) = sum_k AQ[k][t] * W_o[k] in exact int32.
// AQ packs four consecutive k of a token into one word (row k / 4, row stride
// kLd words), as quantize_tile leaves it; W_o = row(o) points at Kp int8
// values, 16-byte aligned, Kp % 16 == 0, zero beyond the true K (AQ is zero
// there too). The pipeline is gemm_w's; a lane does 16 k of two tokens
// against kTN rows with 4 + kTN loads and 8 * kTN __dp4a.
template <class Row, class Epi>
__device__ __forceinline__ void gemm_w_i8(const int* __restrict__ AQ, int Kp, int N, Row row,
                                          Epi epi, int8_t* stages) {
  const int t = 2 * (threadIdx.x & 31);
  const int o0 = (threadIdx.x >> 5) * kTN;
  for (int r0 = 0; r0 < N; r0 += kRoundRows) {
    const int rows = min(kRoundRows, N - r0);
    auto stage_in = [&](int s, int k0) {
      const int chunks = min(kKTileI8, Kp - k0) / 16;
      for (int c = threadIdx.x; c < rows * chunks; c += kThreads) {
        const int o = c / chunks, q = c % chunks;
        cp_async<16>(stages + (s * kRoundRows + o) * kKTileI8 + 16 * q,
                     row(r0 + o) + k0 + 16 * q);
      }
      cp_async_commit();
    };
    int acc0[kTN], acc1[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      acc0[j] = 0;
      acc1[j] = 0;
    }
    stage_in(0, 0);
    for (int k0 = 0, s = 0; k0 < Kp; k0 += kKTileI8, s ^= 1) {
      if (k0 + kKTileI8 < Kp) {
        stage_in(s ^ 1, k0 + kKTileI8);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int8_t* w = stages + (s * kRoundRows + o0) * kKTileI8;
      const int kn = min(kKTileI8, Kp - k0);
      for (int kk = 0; kk < kn; kk += 16) {
        const int* a = AQ + ((k0 + kk) >> 2) * kLd + t;
        const int2 a0 = *reinterpret_cast<const int2*>(a);
        const int2 a1 = *reinterpret_cast<const int2*>(a + kLd);
        const int2 a2 = *reinterpret_cast<const int2*>(a + 2 * kLd);
        const int2 a3 = *reinterpret_cast<const int2*>(a + 3 * kLd);
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const int4 b = *reinterpret_cast<const int4*>(w + j * kKTileI8 + kk);
          acc0[j] = __dp4a(a0.x, b.x, acc0[j]);
          acc1[j] = __dp4a(a0.y, b.x, acc1[j]);
          acc0[j] = __dp4a(a1.x, b.y, acc0[j]);
          acc1[j] = __dp4a(a1.y, b.y, acc1[j]);
          acc0[j] = __dp4a(a2.x, b.z, acc0[j]);
          acc1[j] = __dp4a(a2.y, b.z, acc1[j]);
          acc0[j] = __dp4a(a3.x, b.w, acc0[j]);
          acc1[j] = __dp4a(a3.y, b.w, acc1[j]);
        }
      }
      __syncthreads();  // the stage is refilled next
    }
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      if (o0 + j < rows) epi(r0 + o0 + j, t, acc0[j], acc1[j]);
  }
}

// Symmetric int8 quantisation of the `rows` features of the tile's n tokens
// in the feature-major A, with one dynamic scale for the whole tile:
// s = max(absmax, 1e-12) / 127, q = clip(rint(v * (1 / s)), -127, 127)
// (rint rounds half to even). AQ receives rows_p / 4 rows of packed words
// (rows_p % 16 == 0), zero for features >= rows and tokens >= n. red is
// kWarps floats of scratch. Returns s to every thread; ends with the block
// in step.
__device__ inline float quantize_tile(const float* A, int rows, int rows_p, int n, int* AQ,
                                      float* red) {
  float m = 0.f;
  for (int e = threadIdx.x; e < rows * kTok; e += kThreads) {
    const int t = e % kTok;
    if (t < n) m = fmaxf(m, fabsf(A[(e / kTok) * kLd + t]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) m = fmaxf(m, red[i]);
  const float s = fmaxf(m, 1e-12f) * (1.f / 127.f);
  const float inv = 1.f / s;
  for (int e = threadIdx.x; e < (rows_p / 4) * kTok; e += kThreads) {
    const int g = e / kTok, t = e % kTok;
    unsigned word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * g + i;
      const float v = r < rows && t < n ? A[r * kLd + t] : 0.f;
      const int q = static_cast<int>(fminf(fmaxf(rintf(v * inv), -127.f), 127.f));
      word |= static_cast<unsigned>(q & 0xff) << (8 * i);
    }
    AQ[g * kLd + t] = static_cast<int>(word);
  }
  __syncthreads();
  return s;
}

// As gemm_w, with the second operand b(o, k) in shared memory (the same
// address across a warp, so each read is a broadcast).
template <int TN, class B, class Epi>
__device__ __forceinline__ void gemm_s(const float* __restrict__ A, int K, int N, B b, Epi epi) {
  const int t = 2 * (threadIdx.x & 31);
  for (int o0 = (threadIdx.x >> 5) * TN; o0 < N; o0 += kWarps * TN) {
    float acc0[TN], acc1[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc0[j] = 0.f;
      acc1[j] = 0.f;
    }
    for (int k = 0; k < K; ++k) {
      const float2 a = *reinterpret_cast<const float2*>(A + k * kLd + t);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float v = b(min(o0 + j, N - 1), k);
        acc0[j] = fmaf(a.x, v, acc0[j]);
        acc1[j] = fmaf(a.y, v, acc1[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < TN; ++j)
      if (o0 + j < N) epi(o0 + j, t, acc0[j], acc1[j]);
  }
}

// out(a, b) = sum_t A[a][t] * B[b][t] over all kTok token columns of two
// feature-major shared operands (a < Na, b < Nb): the sums over the tokens
// that weight gradients are. Lane l owns TB columns b = l, l + 32, ... at a
// time, so that epi(a, b, v) can add into device memory whose fastest index
// is b; a warp owns TA rows a at a time, each read as a broadcast.
template <int TA, int TB, class Epi>
__device__ __forceinline__ void gemm_tok(const float* __restrict__ A, int Na,
                                         const float* __restrict__ B, int Nb, Epi epi) {
  const int lane = threadIdx.x & 31;
  for (int b0 = lane; b0 < Nb + lane; b0 += 32 * TB) {  // b0 - lane < Nb: uniform in a warp
    const float* bp[TB];
#pragma unroll
    for (int jb = 0; jb < TB; ++jb) bp[jb] = B + min(b0 + 32 * jb, Nb - 1) * kLd;
    for (int a0 = (threadIdx.x >> 5) * TA; a0 < Na; a0 += kWarps * TA) {
      float acc[TA][TB];
#pragma unroll
      for (int ia = 0; ia < TA; ++ia)
#pragma unroll
        for (int jb = 0; jb < TB; ++jb) acc[ia][jb] = 0.f;
      for (int t = 0; t < kTok; t += 2) {
        float2 bv[TB];
#pragma unroll
        for (int jb = 0; jb < TB; ++jb) bv[jb] = *reinterpret_cast<const float2*>(bp[jb] + t);
#pragma unroll
        for (int ia = 0; ia < TA; ++ia) {
          const float2 av =
              *reinterpret_cast<const float2*>(A + min(a0 + ia, Na - 1) * kLd + t);
#pragma unroll
          for (int jb = 0; jb < TB; ++jb)
            acc[ia][jb] = fmaf(av.y, bv[jb].y, fmaf(av.x, bv[jb].x, acc[ia][jb]));
        }
      }
#pragma unroll
      for (int ia = 0; ia < TA; ++ia)
#pragma unroll
        for (int jb = 0; jb < TB; ++jb)
          if (a0 + ia < Na && b0 + 32 * jb < Nb) epi(a0 + ia, b0 + 32 * jb, acc[ia][jb]);
    }
  }
}

// f(r, sum over the kTok columns of v(r, t)) for every row r < rows, one
// warp per row; f runs on lane 0.
template <class V, class F>
__device__ __forceinline__ void row_sums(int rows, V v, F f) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += kWarps) {
    float s = v(r, 2 * lane) + v(r, 2 * lane + 1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) f(r, s);
  }
}

// sum / max over the kPerTok consecutive lanes that share a token
__device__ __forceinline__ float token_sum(float v) {
#pragma unroll
  for (int o = 1; o < kPerTok; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float token_max(float v) {
#pragma unroll
  for (int o = 1; o < kPerTok; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Y = LN(X) per token (kPerTok threads each): var = E[x^2] - mean^2,
// eps 1e-5, output rounded to the model dtype. With stats (2 * kTok
// floats) it keeps each token's mean and 1 / std for the backward.
template <typename T>
__device__ void layer_norm(const float* X, float* Y, int C, const float* g, const float* b,
                           float* stats = nullptr) {
  const int t = threadIdx.x / kPerTok, part = threadIdx.x % kPerTok;
  float s = 0.f, ss = 0.f;
  for (int c = part; c < C; c += kPerTok) {
    const float v = X[c * kLd + t];
    s += v;
    ss += v * v;
  }
  const float mu = token_sum(s) / C;
  const float inv = rsqrtf(token_sum(ss) / C - mu * mu + 1e-5f);
  for (int c = part; c < C; c += kPerTok)
    Y[c * kLd + t] = round_to<T>((X[c * kLd + t] - mu) * inv * g[c] + b[c]);
  if (stats && part == 0) {
    stats[t] = mu;
    stats[kTok + t] = inv;
  }
}

// LayerNorm backward of one tile, in place: D holds dL/d LN(x) on entry and
// dL/dx on return; X is x, stats what layer_norm kept. The gradients of the
// affine (sums over the tile's tokens) are added to dg and db in device
// memory. Ends with the block in step.
__device__ inline void layer_norm_backward(const float* X, float* D, int C, const float* g,
                                           const float* stats, float* dg, float* db) {
  auto xhat = [&](int c, int t) { return (X[c * kLd + t] - stats[t]) * stats[kTok + t]; };
  row_sums(C, [&](int c, int t) { return D[c * kLd + t] * xhat(c, t); },
           [&](int c, float v) { atomicAdd(dg + c, v); });
  row_sums(C, [&](int c, int t) { return D[c * kLd + t]; },
           [&](int c, float v) { atomicAdd(db + c, v); });
  __syncthreads();
  const int t = threadIdx.x / kPerTok, part = threadIdx.x % kPerTok;
  float s1 = 0.f, s2 = 0.f;
  for (int c = part; c < C; c += kPerTok) {
    const float d = D[c * kLd + t] * g[c];
    s1 += d;
    s2 += d * xhat(c, t);
  }
  const float m1 = token_sum(s1) / C, m2 = token_sum(s2) / C;
  const float inv = stats[kTok + t];
  for (int c = part; c < C; c += kPerTok)
    D[c * kLd + t] = inv * (D[c * kLd + t] * g[c] - m1 - xhat(c, t) * m2);
  __syncthreads();
}

// Softmax over the n keys of each query column of the key-major scores S,
// probabilities rounded to the model dtype.
template <typename T>
__device__ void softmax_keys(float* S, int n) {
  const int i = threadIdx.x / kPerTok, part = threadIdx.x % kPerTok;
  float m = -INFINITY;
  for (int j = part; j < n; j += kPerTok) m = fmaxf(m, S[j * kLd + i]);
  m = token_max(m);
  float s = 0.f;
  for (int j = part; j < n; j += kPerTok) {
    const float e = expf(S[j * kLd + i] - m);
    S[j * kLd + i] = e;
    s += e;
  }
  s = token_sum(s);
  for (int j = part; j < n; j += kPerTok) S[j * kLd + i] = round_to<T>(S[j * kLd + i] / s);
}

// q (scaled), k, v of head h for the tile's tokens: QKV (3 * hd rows) =
// round(LN(x) Wqkv_h^T + bqkv_h), q then scaled in float32.
template <typename T>
__device__ __forceinline__ void head_qkv(const float* XN, float* QKV, int C, int hd, int h,
                                         const T* wqkv, const float* bqkv, float scale,
                                         T* stages) {
  // output o of q|k|v is row (o / hd) * C + h * hd + o % hd of Wqkv
  auto qkv_row = [&](int o) { return (o / hd) * C + h * hd + o % hd; };
  gemm_w<T>(
      XN, C, 3 * hd, [&](int o) { return wqkv + static_cast<size_t>(qkv_row(o)) * C; },
      [&](int o, int t, float v0, float v1) {
        const float b = bqkv[qkv_row(o)];
        const float s = o < hd ? scale : 1.f;
        *reinterpret_cast<float2*>(QKV + o * kLd + t) =
            make_float2(round_to<T>(v0 + b) * s, round_to<T>(v1 + b) * s);
      }, stages);
}

// head_qkv on the quantised LN(x) (AQ, scale sx) and int8 weights of Kp
// values a row with their scales sw: round(acc * (sx * sw) + bqkv_h).
template <typename T>
__device__ __forceinline__ void head_qkv_i8(const int* AQ, float* QKV, int C, int Kp, int hd,
                                            int h, const int8_t* wqkv, const float* sw,
                                            const float* bqkv, float sx, float scale,
                                            int8_t* stages) {
  auto qkv_row = [&](int o) { return (o / hd) * C + h * hd + o % hd; };
  gemm_w_i8(
      AQ, Kp, 3 * hd, [&](int o) { return wqkv + static_cast<size_t>(qkv_row(o)) * Kp; },
      [&](int o, int t, int v0, int v1) {
        const int r = qkv_row(o);
        const float d = sx * sw[r], b = bqkv[r];
        const float s = o < hd ? scale : 1.f;
        *reinterpret_cast<float2*>(QKV + o * kLd + t) =
            make_float2(round_to<T>(dequant(v0, d) + b) * s, round_to<T>(dequant(v1, d) + b) * s);
      }, stages);
}

// Attention probabilities of one head, key-major in S (S[j][i] for query i
// and key j < n): softmax(q k^T + rel_bias (+ mask)), rounded to T.
// Ends with the block in step.
template <typename T>
__device__ __forceinline__ void head_probs(const float* QKV, float* S, int hd, int n,
                                           const float* rel_bias_h, const float* mask) {
  const float* Q = QKV;
  const float* K = QKV + hd * kLd;
  // S[j][i] = bias[i][j] (+ mask[i][j]): read along j, coalesced
  for (int e = threadIdx.x; e < n * n; e += kThreads)
    S[(e % n) * kLd + e / n] = rel_bias_h[e] + (mask ? mask[e] : 0.f);
  __syncthreads();
  gemm_s<4>(
      Q, hd, n, [&](int j, int d) { return K[d * kLd + j]; },
      [&](int j, int i, float v0, float v1) {
        float2* ps = reinterpret_cast<float2*>(S + j * kLd + i);
        const float2 c = *ps;
        *ps = make_float2(v0 + c.x, v1 + c.y);
      });
  __syncthreads();
  softmax_keys<T>(S, n);
  __syncthreads();
}

}  // namespace swin
