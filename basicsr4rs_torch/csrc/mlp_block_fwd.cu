// Transformer MLP branch, forward: LN -> fc1 -> exact GELU -> fc2, one
// thread block per tile of 64 tokens.
//
// Replaces basicsr4rs_tpu/ops/mlp_block.py::_mlp_fwd_kernel (the Pallas
// kernel behind fused_mlp_block). For x (T, C) it writes
//
//   z = fc2(GELU(fc1(LN(x))))   as   z,   z + x,   or   s[sample] * z + x
//
// (the last folds DropPath's per-sample scale and the residual into the
// kernel). LN statistics and every accumulation are float32; GEMM inputs are
// rounded to the model dtype (float32 or bfloat16).
//
// What bounds it on an H100: compute. Per token it does 4 * C * hidden
// FLOP (0.26 MFLOP at C=180, hidden=360) against 2 * C elements of traffic;
// the weights stay in L2. As in the joint forward kernel the hidden
// activation never lives whole: fc1 -> GELU -> fc2 runs in chunks of 96
// hidden columns kept in shared memory (64 past C = 192, so that SwinIR-L's
// C = 240 fits: 231,552 bytes a block where 96 would take 240,000), the
// weights stream through two cp.async stages, and each thread holds a
// 2-token x 6-column register tile on the CUDA cores. Tensor cores are
// later work.

#include "swin_common.cuh"

namespace {

using namespace swin;

struct Params {
  const void* x;
  void* out;
  int tokens, channels, hidden, tokens_per_sample;
  const float* ln_w;
  const float* ln_b;
  const void* w1;  // (hidden, C)
  const float* b1;
  const void* w2;  // (C, hidden)
  const float* b2;
  int mode;
  const float* s;  // (samples,) when mode == kScaled
};

// Hidden columns a chunk: kHidChunk, or 64 where 96 would not fit (C > 192)
__host__ __device__ inline int chunk_of(int channels) { return channels <= 192 ? kHidChunk : 64; }

// Float offset of the weight stages: after x, LN(x), the fc2 sum and one
// hidden chunk, 16-byte aligned.
__host__ __device__ inline int stage_offset(int channels) {
  return ((3 * channels + chunk_of(channels)) * kLd + 3) / 4 * 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) mlp_block_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  const int C = p.channels, hidden = p.hidden;
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  const T* w1 = static_cast<const T*>(p.w1);
  const T* w2 = static_cast<const T*>(p.w2);
  const float *b1 = p.b1, *b2 = p.b2;
  const int tok0 = blockIdx.x * kTok;
  const int n = min(kTok, p.tokens - tok0);

  float* X = smem;
  float* XN = X + C * kLd;
  float* AO = XN + C * kLd;   // the fc2 sum
  float* HB = AO + C * kLd;   // GELU(fc1) chunk: chunk rows
  T* stages = reinterpret_cast<T*>(smem + stage_offset(C));

  for (int e = threadIdx.x; e < kTok * C; e += kThreads) {
    const int t = e / C, c = e % C;
    X[c * kLd + t] = t < n ? to_f32(x[static_cast<size_t>(tok0 + t) * C + c]) : 0.f;
  }
  __syncthreads();
  layer_norm<T>(X, XN, C, p.ln_w, p.ln_b);
  for (int e = threadIdx.x; e < C * kLd; e += kThreads) AO[e] = 0.f;
  __syncthreads();

  const int chunk = chunk_of(C);
  for (int j0 = 0; j0 < hidden; j0 += chunk) {
    const int hc = min(chunk, hidden - j0);
    gemm_w<T>(
        XN, C, hc, [&](int o) { return w1 + static_cast<size_t>(j0 + o) * C; },
        [&](int o, int t, float v0, float v1) {
          const float b = b1[j0 + o];
          *reinterpret_cast<float2*>(HB + o * kLd + t) =
              make_float2(round_to<T>(gelu(v0 + b)), round_to<T>(gelu(v1 + b)));
        }, stages);
    __syncthreads();
    gemm_w<T>(
        HB, hc, C, [&](int o) { return w2 + static_cast<size_t>(o) * hidden + j0; },
        [&](int o, int t, float v0, float v1) {
          float2* pa = reinterpret_cast<float2*>(AO + o * kLd + t);
          const float2 a = *pa;
          *pa = make_float2(a.x + v0, a.y + v1);
        }, stages);
    __syncthreads();
  }

  for (int e = threadIdx.x; e < n * C; e += kThreads) {
    const int t = e / C, c = e % C;
    float z = AO[c * kLd + t] + b2[c];
    if (p.mode == kScaled) z *= p.s[(tok0 + t) / p.tokens_per_sample];
    if (p.mode != kBranch) z += X[c * kLd + t];
    out[static_cast<size_t>(tok0 + t) * C + c] = from_f32<T>(z);
  }
}

size_t smem_bytes(int channels) {
  return static_cast<size_t>(stage_offset(channels)) * sizeof(float) +
         kStageElems * sizeof(float);
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.channels);
  cudaError_t err = cudaFuncSetAttribute(mlp_block_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (p.tokens + kTok - 1) / kTok;
  mlp_block_fwd_kernel<T><<<blocks, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one thread block takes, in bytes.
size_t mlp_block_fwd_smem_bytes(int channels) { return smem_bytes(channels); }

// dtype: 0 float32, 1 bfloat16; mode: 0 branch, 1 branch + x, 2 s * branch + x.
// Returns the cudaError_t of the launch (0 on success).
int mlp_block_fwd(int dtype, const void* x, void* out, int tokens, int channels, int hidden,
                  int tokens_per_sample, const float* ln_w, const float* ln_b, const void* w1,
                  const float* b1, const void* w2, const float* b2, int mode, const float* s,
                  void* stream) {
  const Params p{x, out, tokens, channels, hidden, tokens_per_sample, ln_w, ln_b,
                 w1, b1, w2, b2, mode, s};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mlp_block_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
