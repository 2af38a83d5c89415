// Swin attention branch, forward: LN -> qkv -> windowed multi-head
// attention with relative-position bias and shift mask -> proj, one thread
// block per window.
//
// Replaces basicsr4rs_tpu/ops/swin_block.py::_block_fwd_kernel (the Pallas
// kernel behind fused_swin_attn_block). For x (B, H, W, C), already rolled
// by the caller, it writes
//
//   z = proj(W-MSA(LN(x)))   as   z,   z + x,   or   s[b] * z + x
//
// (the last folds DropPath's per-sample scale and the residual into the
// kernel). LN statistics, softmax and every accumulation are float32; GEMM
// inputs are rounded to the model dtype (float32 or bfloat16); the qk scale
// is folded into q in float32.
//
// What bounds it on an H100: compute, about 0.3 MFLOP per token at C=180
// with 6 heads and 8x8 windows against 2 * C elements of traffic; the
// weights stay in L2. It is the attention half of the joint forward
// kernel: a window's LN output, per-head q/k/v and scores, and the attention
// output stay in shared memory, the weights stream through two cp.async
// stages, the CUDA cores do the GEMMs. Tensor cores are later work.

#include "swin_common.cuh"

namespace {

using namespace swin;

struct Params {
  const void* x;
  void* out;
  int batch, height, width, channels, heads, window;
  const float* ln_w;
  const float* ln_b;
  const void* wqkv;  // (3C, C)
  const float* bqkv;
  const void* wproj;  // (C, C)
  const float* bproj;
  const float* rel_bias;  // (heads, n, n)
  const float* mask;      // (nW, n, n) or null
  int mode;
  const float* s;  // (B,) when mode == kScaled
  float scale;
};

// Float offset of the weight stages: after x, LN(x), the attention output,
// one head's q/k/v and its scores, 16-byte aligned.
__host__ __device__ inline int stage_offset(int channels, int heads) {
  return ((3 * channels + 3 * (channels / heads) + kTok) * kLd + 3) / 4 * 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) swin_attn_block_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  const int H = p.height, W = p.width, C = p.channels, heads = p.heads;
  const int ws = p.window, n = ws * ws, hd = C / heads;
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  const T* wqkv = static_cast<const T*>(p.wqkv);
  const T* wproj = static_cast<const T*>(p.wproj);
  const float* bproj = p.bproj;

  const int nww = W / ws, nw = (H / ws) * nww;
  const int img = blockIdx.x / nw, win = blockIdx.x % nw;
  const int row0 = (win / nww) * ws, col0 = (win % nww) * ws;
  const float* mask = p.mask ? p.mask + static_cast<size_t>(win) * n * n : nullptr;
  const float s = p.mode == kScaled ? p.s[img] : 1.f;
  const bool residual = p.mode != kBranch;

  float* X = smem;                // x, then the output
  float* XN = X + C * kLd;        // LN(x)
  float* AO = XN + C * kLd;       // attention output
  float* QKV = AO + C * kLd;      // q (scaled), k, v of one head: 3 * hd rows
  float* S = QKV + 3 * hd * kLd;  // scores of one head, key-major: kTok rows
  T* stages = reinterpret_cast<T*>(smem + stage_offset(C, heads));
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
  layer_norm<T>(X, XN, C, p.ln_w, p.ln_b);
  __syncthreads();

  for (int h = 0; h < heads; ++h) {
    head_qkv<T>(XN, QKV, C, hd, h, wqkv, p.bqkv, p.scale, stages);
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

  // out = a Wproj^T + bproj, scaled and added to x as the mode says, in place
  gemm_w<T>(
      AO, C, C, [&](int o) { return wproj + static_cast<size_t>(o) * C; },
      [&](int o, int t, float v0, float v1) {
        float2* px = reinterpret_cast<float2*>(X + o * kLd + t);
        const float2 xv = residual ? *px : make_float2(0.f, 0.f);
        const float b = bproj[o];
        *px = make_float2((v0 + b) * s + xv.x, (v1 + b) * s + xv.y);
      }, stages);
  __syncthreads();
  for (int e = threadIdx.x; e < n * C; e += kThreads) {
    const int t = e / C, c = e % C;
    out[offset(t) + c] = from_f32<T>(X[c * kLd + t]);
  }
}

size_t smem_bytes(int channels, int heads) {
  return static_cast<size_t>(stage_offset(channels, heads)) * sizeof(float) +
         kStageElems * sizeof(float);
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.channels, p.heads);
  cudaError_t err = cudaFuncSetAttribute(swin_attn_block_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = p.batch * (p.height / p.window) * (p.width / p.window);
  swin_attn_block_fwd_kernel<T><<<blocks, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one thread block takes, in bytes.
size_t swin_attn_block_fwd_smem_bytes(int channels, int heads) {
  return smem_bytes(channels, heads);
}

// dtype: 0 float32, 1 bfloat16; mode: 0 branch, 1 branch + x, 2 s * branch + x.
// Returns the cudaError_t of the launch (0 on success).
int swin_attn_block_fwd(int dtype, const void* x, void* out, int batch, int height, int width,
                        int channels, int heads, int window, const float* ln_w,
                        const float* ln_b, const void* wqkv, const float* bqkv,
                        const void* wproj, const float* bproj, const float* rel_bias,
                        const float* mask, int mode, const float* s, float scale, void* stream) {
  const Params p{x,    out,  batch, height, width, channels, heads,    window, ln_w,
                 ln_b, wqkv, bqkv,  wproj,  bproj, rel_bias, mask,     mode,   s,
                 scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* swin_attn_block_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
