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

#include "swin_common.cuh"

namespace {

using namespace swin;

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
    head_qkv<T>(XN, QKV, C, hd, h, wqkv, bqkv, scale, stages);
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
  return (static_cast<size_t>(stage_offset(channels, heads)) + kStageElems) * sizeof(float);
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
