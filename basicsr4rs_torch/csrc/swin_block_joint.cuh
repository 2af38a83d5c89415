// The whole Swin transformer block, forward, one thread block per window:
// the body shared by swin_block_joint_fwd.cu (float32 / bfloat16 products) and
// swin_block_joint_int8_fwd.cu (the four weight products in int8).
//
// For x (B, H, W, C), already rolled by the caller,
//
//   y   = x + s1 * proj(W-MSA(LN1(x)))     // relative-position bias (+ shift mask)
//   out = y + s2 * fc2(GELU(fc1(LN2(y))))
//
// with LN statistics, softmax and every accumulation of a float product in
// float32, the qk scale folded into q in float32 and exact (erf) GELU. s1,
// s2 are DropPath's per-sample scales (1 when the pointers are null).
//
// kInt8 = false: GEMM inputs are rounded to the model dtype T; the MLP hidden
// goes through shared memory in chunks of kHidChunk columns.
//
// kInt8 = true: qkv, proj, fc1 and fc2 are int8 x int8 -> int32 (__dp4a).
// Weights come quantised per output channel (int8 rows padded with zeros to
// a multiple of 16, float32 scales). The activation entering each product
// (LN1's output, the attention output, LN2's output, GELU's output) is
// quantised in float32 (LN's and GELU's outputs unrounded, the attention
// output rounded to T as in the float kernel), with one dynamic scale for the block's
// tile, which is one window of ws * ws tokens, and the sum is dequantised as
// acc * (s_x * s_w[col]) + bias in float32. The whole GELU output of the
// window stays in shared memory (its absmax is needed before fc2 starts),
// over the buffers the attention half has finished with. q.k, p.v, softmax,
// LayerNorm, GELU and the residuals are as in the float kernel.
//
// Layout in shared memory: activations are feature-major, one row of kTok
// floats per feature (row stride kLd), so lane l of a warp owns tokens 2l and
// 2l+1 and reads them as one float2; staged weights keep the nn.Linear
// (out, in) layout, and every lane of a warp reads the same ones (a
// broadcast). Quantised activations pack four features of a token in a word.

#pragma once

#include <type_traits>

#include "swin_common.cuh"

namespace swin {

__host__ __device__ inline int round_up16(int v) { return (v + 15) / 16 * 16; }

// Float offset of the weight-GEMM stages: after x, the two C-row buffers and
// the scratch rows (q/k/v + scores, or the MLP hidden chunk), 16-byte
// aligned. The int8 kernel keeps all `hidden_rows` rows of the GELU output
// in the rows after x.
__host__ __device__ inline int stage_offset(int channels, int heads, int hidden_rows) {
  const int hd = channels / heads;
  const int scratch = 3 * hd + kTok > kHidChunk ? 3 * hd + kTok : kHidChunk;
  const int after_x = 2 * channels + scratch > hidden_rows ? 2 * channels + scratch : hidden_rows;
  return ((channels + after_x) * kLd + 3) / 4 * 4;
}

// Rows of packed words that hold a quantised activation (int8 kernel only).
__host__ __device__ inline int quant_rows(int channels, int hidden) {
  return round_up16(channels > hidden ? channels : hidden) / 4;
}

inline size_t joint_smem_bytes(int channels, int heads, int hidden, bool int8) {
  size_t floats = static_cast<size_t>(stage_offset(channels, heads, int8 ? hidden : 0)) + kStageElems;
  if (int8) floats += static_cast<size_t>(quant_rows(channels, hidden)) * kLd + kWarps;
  return floats * sizeof(float);
}

struct JointParams {
  const void* x;
  void* out;
  int batch, height, width, channels, heads, window, hidden;
  const float* ln1_w;
  const float* ln1_b;
  const void* wqkv;  // (3C, C) of T, or int8 (3C, round_up16(C))
  const float* bqkv;
  const void* wproj;  // (C, C)
  const float* bproj;
  const float* rel_bias;  // (heads, n, n)
  const float* mask;      // (nW, n, n) or null
  const float* ln2_w;
  const float* ln2_b;
  const void* w1;  // (hidden, C)
  const float* b1;
  const void* w2;  // (C, hidden), or int8 (C, round_up16(hidden))
  const float* b2;
  float scale;
  const float* s1;  // (B) DropPath scales or null (float kernel)
  const float* s2;
  const float* sqkv;  // per-row weight scales (int8 kernel)
  const float* sproj;
  const float* sw1;
  const float* sw2;
  // what the int8 kernel quantised, for checks; both null in serving.
  // quant_q: the int8 inputs of qkv, proj, fc1 (B, H, W, C each) and fc2
  // (B, H, W, hidden), one after the other; quant_s: their scales, (4, windows)
  int8_t* quant_q;
  float* quant_s;
};

template <typename T, bool kInt8>
__global__ void __launch_bounds__(kThreads) swin_block_joint_kernel(const JointParams p) {
  extern __shared__ float smem[];
  // kernel parameters copied to registers: the lambdas below capture these
  const int H = p.height, W = p.width, C = p.channels, heads = p.heads, hidden = p.hidden;
  const int ws = p.window, n = ws * ws, hd = C / heads;
  const float scale = p.scale;
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  const float *bqkv = p.bqkv, *bproj = p.bproj, *b1 = p.b1, *b2 = p.b2;

  const int nww = W / ws, nw = (H / ws) * nww;
  const int img = blockIdx.x / nw, win = blockIdx.x % nw;
  const int row0 = (win / nww) * ws, col0 = (win % nww) * ws;
  const float* mask = p.mask ? p.mask + static_cast<size_t>(win) * n * n : nullptr;
  const float s1 = p.s1 ? p.s1[img] : 1.f, s2 = p.s2 ? p.s2[img] : 1.f;

  float* X = smem;                // x, then y = x + attention branch
  float* XN = X + C * kLd;        // LN1(x), then LN2(y)
  float* AO = XN + C * kLd;       // attention output, then the MLP sum
  float* QKV = AO + C * kLd;      // q (scaled), k, v of one head: 3 * hd rows
  float* S = QKV + 3 * hd * kLd;  // scores of one head, key-major: kTok rows
  float* HB = QKV;                // GELU(fc1) chunk: kHidChunk rows, aliases QKV and S
  float* const stage_base = smem + stage_offset(C, heads, kInt8 ? hidden : 0);
  const float* V = QKV + 2 * hd * kLd;
  // what a quantised product needs; unused by the float kernel
  using LnT = typename std::conditional<kInt8, float, T>::type;  // LN output unrounded
  const int Cp = round_up16(C), Hp = round_up16(hidden);
  int* Q = reinterpret_cast<int*>(stage_base + kStageElems);
  float* red = reinterpret_cast<float*>(Q + quant_rows(C, hidden) * kLd);
  int8_t* stages8 = reinterpret_cast<int8_t*>(stage_base);
  T* stages = reinterpret_cast<T*>(stage_base);

  // token t of the window sits at row row0 + t / ws, column col0 + t % ws
  auto offset = [&](int t) {
    return ((static_cast<size_t>(img) * H + row0 + t / ws) * W + col0 + t % ws) * C;
  };
  // product `stage` (0 qkv, 1 proj, 2 fc1, 3 fc2) read the `rows` features in Q at scale s
  auto keep_quantised = [&](int stage, int rows, float s) {
    if (p.quant_q == nullptr) return;
    int8_t* dst = p.quant_q + static_cast<size_t>(stage) * p.batch * H * W * C;
    for (int e = threadIdx.x; e < n * rows; e += kThreads) {
      const int t = e / rows, r = e % rows;
      const int word = Q[(r >> 2) * kLd + t];
      dst[offset(t) / C * rows + r] = static_cast<int8_t>((word >> (8 * (r & 3))) & 0xff);
    }
    if (threadIdx.x == 0) p.quant_s[stage * gridDim.x + blockIdx.x] = s;
  };

  for (int e = threadIdx.x; e < kTok * C; e += kThreads) {
    const int t = e / C, c = e % C;
    X[c * kLd + t] = t < n ? to_f32(x[offset(t) + c]) : 0.f;
  }
  __syncthreads();
  layer_norm<LnT>(X, XN, C, p.ln1_w, p.ln1_b);
  __syncthreads();
  float sx = 0.f;
  if constexpr (kInt8) {
    sx = quantize_tile(XN, C, Cp, n, Q, red);
    keep_quantised(0, C, sx);
  }

  for (int h = 0; h < heads; ++h) {
    if constexpr (kInt8)
      head_qkv_i8<T>(Q, QKV, C, Cp, hd, h, static_cast<const int8_t*>(p.wqkv), p.sqkv, bqkv, sx,
                     scale, stages8);
    else
      head_qkv<T>(XN, QKV, C, hd, h, static_cast<const T*>(p.wqkv), bqkv, scale, stages);
    __syncthreads();
    head_probs<T>(QKV, S, hd, n, p.rel_bias + static_cast<size_t>(h) * n * n, mask);
    gemm_s<2>(
        S, n, hd, [&](int d, int j) { return V[d * kLd + j]; },
        [&](int d, int t, float v0, float v1) {
          *reinterpret_cast<float2*>(AO + (h * hd + d) * kLd + t) =
              make_float2(round_to<T>(v0), round_to<T>(v1));
        });
    __syncthreads();
  }

  // y = x + s1 * (a Wproj^T + bproj), in place
  auto add_branch = [&](int o, int t, float v0, float v1) {
    float2* px = reinterpret_cast<float2*>(X + o * kLd + t);
    const float2 xv = *px;
    const float b = bproj[o];
    *px = p.s1 ? make_float2((v0 + b) * s1 + xv.x, (v1 + b) * s1 + xv.y)
               : make_float2(v0 + b + xv.x, v1 + b + xv.y);
  };
  if constexpr (kInt8) {
    const float sa = quantize_tile(AO, C, Cp, n, Q, red);
    keep_quantised(1, C, sa);
    const int8_t* wproj = static_cast<const int8_t*>(p.wproj);
    gemm_w_i8(
        Q, Cp, C, [&](int o) { return wproj + static_cast<size_t>(o) * Cp; },
        [&](int o, int t, int v0, int v1) {
          const float d = sa * p.sproj[o];
          add_branch(o, t, dequant(v0, d), dequant(v1, d));
        }, stages8);
  } else {
    const T* wproj = static_cast<const T*>(p.wproj);
    gemm_w<T>(AO, C, C, [&](int o) { return wproj + static_cast<size_t>(o) * C; }, add_branch,
              stages);
  }
  __syncthreads();
  layer_norm<LnT>(X, XN, C, p.ln2_w, p.ln2_b);

  if constexpr (kInt8) {
    __syncthreads();
    const float sy = quantize_tile(XN, C, Cp, n, Q, red);
    keep_quantised(2, C, sy);
    float* HF = XN;  // the whole GELU output: hidden rows over XN, AO and the scratch
    const int8_t* w1 = static_cast<const int8_t*>(p.w1);
    const int8_t* w2 = static_cast<const int8_t*>(p.w2);
    gemm_w_i8(
        Q, Cp, hidden, [&](int o) { return w1 + static_cast<size_t>(o) * Cp; },
        [&](int o, int t, int v0, int v1) {
          const float d = sy * p.sw1[o], b = b1[o];
          *reinterpret_cast<float2*>(HF + o * kLd + t) =
              make_float2(gelu(dequant(v0, d) + b), gelu(dequant(v1, d) + b));
        }, stages8);
    __syncthreads();
    const float sh = quantize_tile(HF, hidden, Hp, n, Q, red);
    keep_quantised(3, hidden, sh);
    // out = y + (mlp + b2), in place
    gemm_w_i8(
        Q, Hp, C, [&](int o) { return w2 + static_cast<size_t>(o) * Hp; },
        [&](int o, int t, int v0, int v1) {
          const float d = sh * p.sw2[o], b = b2[o];
          float2* px = reinterpret_cast<float2*>(X + o * kLd + t);
          const float2 y = *px;
          *px = make_float2(dequant(v0, d) + b + y.x, dequant(v1, d) + b + y.y);
        }, stages8);
    __syncthreads();
    for (int e = threadIdx.x; e < n * C; e += kThreads) {
      const int t = e / C, c = e % C;
      out[offset(t) + c] = from_f32<T>(X[c * kLd + t]);
    }
  } else {
    const T* w1 = static_cast<const T*>(p.w1);
    const T* w2 = static_cast<const T*>(p.w2);
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
    // out = y + s2 * (mlp + b2)
    for (int e = threadIdx.x; e < n * C; e += kThreads) {
      const int t = e / C, c = e % C;
      const float m = AO[c * kLd + t] + b2[c], y = X[c * kLd + t];
      out[offset(t) + c] = from_f32<T>(p.s2 ? m * s2 + y : m + y);
    }
  }
}

template <typename T, bool kInt8>
int launch_joint(const JointParams& p, cudaStream_t stream) {
  const size_t smem = joint_smem_bytes(p.channels, p.heads, p.hidden, kInt8);
  cudaError_t err = cudaFuncSetAttribute(swin_block_joint_kernel<T, kInt8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = p.batch * (p.height / p.window) * (p.width / p.window);
  swin_block_joint_kernel<T, kInt8><<<blocks, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 float32, 1 bfloat16. Returns the cudaError_t of the launch (0 on success).
template <bool kInt8>
int launch_joint(int dtype, const JointParams& p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_joint<float, kInt8>(p, s);
  if (dtype == 1) return launch_joint<__nv_bfloat16, kInt8>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace swin
