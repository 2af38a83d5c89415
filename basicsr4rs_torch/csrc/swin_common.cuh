// Device code shared by the port's kernels: the Swin block kernels' block
// shape (kThreads threads on a tile of at most kTok tokens: one attention
// window, or kTok consecutive tokens of the MLP), the output modes of the
// branch kernels, the model dtype's roundings, cp.async's commit and wait,
// GELU and its derivative, and the sum over the lanes that share a token.
// Every value that feeds a product is first rounded to the model dtype T
// (float32 or bfloat16); sums are float32.

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
constexpr int kPerTok = kThreads / kTok;  // threads per token in a token reduction
static_assert(kPerTok == 8, "token_sum uses 8 lanes");

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
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

// sum over the kPerTok consecutive lanes that share a token
__device__ __forceinline__ float token_sum(float v) {
#pragma unroll
  for (int o = 1; o < kPerTok; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace swin
