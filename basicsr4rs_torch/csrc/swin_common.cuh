// Device code shared by the Swin block kernels on the CUDA cores (the split
// attention and MLP branches' forward kernels; the joint forward and the
// backward kernels take its constants and cp.async).
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
// gemm_w is the product with a weight, out(o, t) = sum_k A[k][t] W[o][k]
// (y = x W^T, weight rows); gemm_s is gemm_w with the second operand in
// shared memory.

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
// eps 1e-5, output rounded to the model dtype.
template <typename T>
__device__ void layer_norm(const float* X, float* Y, int C, const float* g, const float* b) {
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
