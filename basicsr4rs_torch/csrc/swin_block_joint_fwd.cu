// Whole Swin transformer block, forward, one thread block per window.
//
// Replaces basicsr4rs_tpu/ops/swin_block.py::_joint_fwd_kernel (the Pallas
// kernel behind fused_swin_block_full). For x (B, H, W, C), already rolled by
// the caller, it computes
//
//   y   = x + proj(W-MSA(LN1(x)))          // relative-position bias (+ shift mask)
//   out = y + fc2(GELU(fc1(LN2(y))))
//
// with LN statistics, softmax and every GEMM accumulation in float32, GEMM
// inputs rounded to the model dtype (float32 or bfloat16), the qk scale folded
// into q in float32, and exact (erf) GELU.
//
// What bounds it on an H100: compute. A SwinIR-M block (C=180, 6 heads of 30,
// 8x8 windows, hidden 360) does about 0.56 MFLOP per token against about
// 1.4 KB of float32 activation traffic (x in, out back), and its ~1 MB of
// float32 weights stay resident in the 50 MB L2. The design keeps every
// intermediate of a window (LN outputs, q/k/v, scores, the attention output,
// the MLP hidden) in shared memory, so device memory sees only x, out and the
// L2-resident weights, and feeds the CUDA cores from shared memory: the
// weights of each GEMM stream through two shared-memory stages by cp.async,
// so their L2 latency overlaps the math, and each thread holds a 2-token x
// 6-column register tile. 16 warps per window; the ~200 KB of shared memory
// allows one window per SM. Tensor cores (wgmma/mma.sync) and TMA are later
// work.
//
// Layout in shared memory: activations are feature-major, one row of kTok
// floats per feature (row stride kLd), so lane l of a warp owns tokens 2l and
// 2l+1 and reads them as one float2; staged weights keep the nn.Linear
// (out, in) layout, kKTile elements of K per row and stage, and every lane of
// a warp reads the same four of them (a broadcast).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTok = 64;        // tokens per window, padded; ws * ws <= kTok
constexpr int kLd = kTok + 2;   // row stride: even for float2, 2-way banks on transposes
constexpr int kHidChunk = 96;   // MLP hidden columns per chunk (multiple of 4)
constexpr int kTN = 6;          // weight GEMMs: output columns per warp and round
constexpr int kRoundRows = kWarps * kTN;  // weight rows staged per round
constexpr int kKTile = 32;      // weight GEMMs: K elements per pipeline stage
constexpr int kPerTok = kThreads / kTok;  // threads per token in LayerNorm and softmax
static_assert(kPerTok == 8, "the token reductions below use 8 lanes");

// Float offset of the weight-GEMM stages: after x, the two C-row buffers and
// the scratch rows (q/k/v + scores, or the MLP hidden chunk), 16-byte aligned.
__host__ __device__ inline int stage_offset(int channels, int heads) {
  const int hd = channels / heads;
  const int scratch = 3 * hd + kTok > kHidChunk ? 3 * hd + kTok : kHidChunk;
  return ((3 * channels + scratch) * kLd + 3) / 4 * 4;
}

struct Params {
  const void* x;
  void* out;
  int batch, height, width, channels, heads, window, hidden;
  const float* ln1_w;
  const float* ln1_b;
  const void* wqkv;  // (3C, C)
  const float* bqkv;
  const void* wproj;  // (C, C)
  const float* bproj;
  const float* rel_bias;  // (heads, n, n)
  const float* mask;      // (nW, n, n) or null
  const float* ln2_w;
  const float* ln2_b;
  const void* w1;  // (hidden, C)
  const float* b1;
  const void* w2;  // (C, hidden)
  const float* b2;
  float scale;
};

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

// cp.async of 4 elements (16 B of float, 8 B of bfloat16) into shared memory
template <typename T>
__device__ __forceinline__ void cp_async4(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
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
        cp_async4(stages + (s * kRoundRows + o) * kKTile + 4 * q, row(r0 + o) + k0 + 4 * q);
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

template <typename T>
__global__ void __launch_bounds__(kThreads) swin_block_joint_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  // kernel parameters copied to registers: the lambdas below capture these
  const int H = p.height, W = p.width, C = p.channels, heads = p.heads, hidden = p.hidden;
  const int ws = p.window, n = ws * ws, hd = C / heads;
  const float scale = p.scale;
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  const T* wqkv = static_cast<const T*>(p.wqkv);
  const T* wproj = static_cast<const T*>(p.wproj);
  const T* w1 = static_cast<const T*>(p.w1);
  const T* w2 = static_cast<const T*>(p.w2);
  const float *bqkv = p.bqkv, *bproj = p.bproj, *b1 = p.b1, *b2 = p.b2;

  const int nww = W / ws, nw = (H / ws) * nww;
  const int img = blockIdx.x / nw, win = blockIdx.x % nw;
  const int row0 = (win / nww) * ws, col0 = (win % nww) * ws;
  const float* mask = p.mask ? p.mask + static_cast<size_t>(win) * n * n : nullptr;

  float* X = smem;                // x, then y = x + attention branch
  float* XN = X + C * kLd;        // LN1(x), then LN2(y)
  float* AO = XN + C * kLd;       // attention output, then the MLP sum
  float* QKV = AO + C * kLd;      // q (scaled), k, v of one head: 3 * hd rows
  float* S = QKV + 3 * hd * kLd;  // scores of one head, key-major: kTok rows
  float* HB = QKV;                // GELU(fc1) chunk: kHidChunk rows, aliases QKV and S
  T* stages = reinterpret_cast<T*>(smem + stage_offset(C, heads));  // weight GEMM stages
  const float* Q = QKV;
  const float* K = QKV + hd * kLd;
  const float* V = QKV + 2 * hd * kLd;

  // token t of the window sits at row row0 + t / ws, column col0 + t % ws
  auto offset = [&](int t) {
    return ((static_cast<size_t>(img) * H + row0 + t / ws) * W + col0 + t % ws) * C;
  };

  for (int e = threadIdx.x; e < kTok * C; e += kThreads) {
    const int t = e / C, c = e % C;
    X[c * kLd + t] = t < n ? to_f32(x[offset(t) + c]) : 0.f;
  }
  __syncthreads();
  layer_norm<T>(X, XN, C, p.ln1_w, p.ln1_b);
  __syncthreads();

  for (int h = 0; h < heads; ++h) {
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
    __syncthreads();
    // S[j][i] = bias[i][j] (+ mask[i][j]): read along j, coalesced
    const float* rb = p.rel_bias + static_cast<size_t>(h) * n * n;
    for (int e = threadIdx.x; e < n * n; e += kThreads)
      S[(e % n) * kLd + e / n] = rb[e] + (mask ? mask[e] : 0.f);
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
    gemm_s<2>(
        S, n, hd, [&](int d, int j) { return V[d * kLd + j]; },
        [&](int d, int t, float v0, float v1) {
          *reinterpret_cast<float2*>(AO + (h * hd + d) * kLd + t) =
              make_float2(round_to<T>(v0), round_to<T>(v1));
        });
    __syncthreads();
  }

  // y = x + (a Wproj^T + bproj), in place
  gemm_w<T>(
      AO, C, C, [&](int o) { return wproj + static_cast<size_t>(o) * C; },
      [&](int o, int t, float v0, float v1) {
        float2* px = reinterpret_cast<float2*>(X + o * kLd + t);
        const float2 xv = *px;
        const float b = bproj[o];
        *px = make_float2(v0 + b + xv.x, v1 + b + xv.y);
      }, stages);
  __syncthreads();
  layer_norm<T>(X, XN, C, p.ln2_w, p.ln2_b);
  for (int e = threadIdx.x; e < C * kLd; e += kThreads) AO[e] = 0.f;
  __syncthreads();

  for (int j0 = 0; j0 < hidden; j0 += kHidChunk) {
    const int hc = min(kHidChunk, hidden - j0);
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

  // out = y + (mlp + b2)
  for (int e = threadIdx.x; e < n * C; e += kThreads) {
    const int t = e / C, c = e % C;
    out[offset(t) + c] = from_f32<T>(AO[c * kLd + t] + b2[c] + X[c * kLd + t]);
  }
}

template <typename T>
int launch(const Params& p, int blocks, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(swin_block_joint_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  swin_block_joint_fwd_kernel<T><<<blocks, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one thread block takes, in bytes.
size_t swin_block_joint_fwd_smem_bytes(int channels, int heads) {
  return (static_cast<size_t>(stage_offset(channels, heads)) + 2 * kRoundRows * kKTile) *
         sizeof(float);
}

// dtype: 0 float32, 1 bfloat16. Returns the cudaError_t of the launch (0 on success).
int swin_block_joint_fwd(int dtype, const void* x, void* out, int batch, int height, int width,
                         int channels, int heads, int window, int hidden, const float* ln1_w,
                         const float* ln1_b, const void* wqkv, const float* bqkv,
                         const void* wproj, const float* bproj, const float* rel_bias,
                         const float* mask, const float* ln2_w, const float* ln2_b,
                         const void* w1, const float* b1, const void* w2, const float* b2,
                         float scale, void* stream) {
  const Params p{x,     out,   batch, height, width, channels, heads, window, hidden,
                 ln1_w, ln1_b, wqkv,  bqkv,   wproj, bproj,    rel_bias, mask, ln2_w,
                 ln2_b, w1,    b1,    w2,     b2,    scale};
  const int blocks = batch * (height / window) * (width / window);
  const size_t smem = swin_block_joint_fwd_smem_bytes(channels, heads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, blocks, smem, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, blocks, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* swin_block_joint_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
