// Transformer MLP branch, backward: one thread block per tile of 64 tokens.
//
// Replaces basicsr4rs_tpu/ops/mlp_block.py::_mlp_bwd_kernel. From x and the
// cotangent dz alone it recomputes LN(x), fc1 and GELU and emits
//
//   dx, d ln_w, d ln_b, d W1, d b1, d W2, d b2
//
// of  out = z,  z + x  or  s[sample] * z + x  with z = fc2(GELU(fc1(LN(x)))).
// The branch cotangent is s[sample] * dz, the residual cotangent dz itself.
// GEMM inputs are rounded to the model dtype, every sum is float32.
//
// What bounds it on an H100: compute, five GEMMs of 2 * C * hidden FLOP per
// token (0.65 MFLOP at C=180, hidden=360) against 3 * C elements of
// activation traffic. The TPU kernel keeps the weight gradients resident
// over a sequential grid; thread blocks here run in parallel, and the
// gradients of one layer (130k floats) exceed a block's shared memory, so
// each block adds its tile's partial sums into the zeroed float32 gradient
// buffer with atomicAdd, lanes along the fastest index so that a warp's
// adds share cache lines. The sum's order, hence its last bits, changes
// from run to run. The hidden activation goes in chunks of 96 columns, as
// in the forward kernel; dx of the transposed weights reads the weights in
// place (gemm_wt), no transposed copy is made.

#include "swin_common.cuh"

namespace {

using namespace swin;

struct Params {
  const void* x;
  const void* dz;
  void* dx;
  int tokens, channels, hidden, tokens_per_sample;
  const float* ln_w;
  const float* ln_b;
  const void* w1;  // (hidden, C)
  const float* b1;
  const void* w2;  // (C, hidden)
  int mode;
  const float* s;  // (samples,) when mode == kScaled
  // float32 gradients, zeroed before the launch
  float* dln_w;
  float* dln_b;
  float* dw1;
  float* db1;
  float* dw2;
  float* db2;
};

// Float offset of the weight stages: after three C-row buffers, the two
// hidden chunks and the LN statistics, 16-byte aligned.
__host__ __device__ inline int stage_offset(int channels) {
  return ((3 * channels + 2 * kHidChunk) * kLd + 2 * kTok + 3) / 4 * 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) mlp_block_bwd_kernel(const Params p) {
  extern __shared__ float smem[];
  const int C = p.channels, hidden = p.hidden;
  const T* x = static_cast<const T*>(p.x);
  const T* dz = static_cast<const T*>(p.dz);
  T* dx = static_cast<T*>(p.dx);
  const T* w1 = static_cast<const T*>(p.w1);
  const T* w2 = static_cast<const T*>(p.w2);
  const float* b1 = p.b1;
  float *dw1 = p.dw1, *db1 = p.db1, *dw2 = p.dw2, *db2 = p.db2;
  const int tok0 = blockIdx.x * kTok;
  const int n = min(kTok, p.tokens - tok0);

  float* D = smem;             // x, then dL/d LN(x), then dx
  float* XN = D + C * kLd;     // LN(x), then x again
  float* DZ = XN + C * kLd;    // the branch cotangent
  float* HP = DZ + C * kLd;    // fc1 output before GELU, then its cotangent
  float* HB = HP + kHidChunk * kLd;  // GELU(fc1), then the rounded cotangent
  float* stats = HB + kHidChunk * kLd;
  T* stages = reinterpret_cast<T*>(smem + stage_offset(C));

  for (int e = threadIdx.x; e < kTok * C; e += kThreads) {
    const int t = e / C, c = e % C;
    float xv = 0.f, dv = 0.f;
    if (t < n) {
      const size_t g = static_cast<size_t>(tok0 + t) * C + c;
      xv = to_f32(x[g]);
      dv = to_f32(dz[g]);
      if (p.mode == kScaled) dv *= p.s[(tok0 + t) / p.tokens_per_sample];
    }
    D[c * kLd + t] = xv;
    DZ[c * kLd + t] = dv;
  }
  __syncthreads();
  layer_norm<T>(D, XN, C, p.ln_w, p.ln_b, stats);
  row_sums(C, [&](int c, int t) { return DZ[c * kLd + t]; },
           [&](int c, float v) { atomicAdd(db2 + c, v); });
  __syncthreads();
  for (int e = threadIdx.x; e < C * kLd; e += kThreads) {
    D[e] = 0.f;
    DZ[e] = round_to<T>(DZ[e]);
  }
  __syncthreads();

  for (int j0 = 0; j0 < hidden; j0 += kHidChunk) {
    const int hc = min(kHidChunk, hidden - j0);
    // recompute: HP = fc1(LN(x)), HB = GELU(HP)
    gemm_w<T>(
        XN, C, hc, [&](int o) { return w1 + static_cast<size_t>(j0 + o) * C; },
        [&](int o, int t, float v0, float v1) {
          const float b = b1[j0 + o];
          *reinterpret_cast<float2*>(HP + o * kLd + t) = make_float2(v0 + b, v1 + b);
          *reinterpret_cast<float2*>(HB + o * kLd + t) =
              make_float2(round_to<T>(gelu(v0 + b)), round_to<T>(gelu(v1 + b)));
        }, stages);
    __syncthreads();
    // dW2[c][j0 + j] += sum_t dz[c][t] h[j][t]
    gemm_tok<12, 3>(DZ, C, HB, hc, [&](int c, int j, float v) {
      atomicAdd(dw2 + static_cast<size_t>(c) * hidden + j0 + j, v);
    });
    __syncthreads();
    // dh = dz W2[:, chunk]; through the GELU: HP = dh * gelu'(HP), HB its rounding
    gemm_wt<T, 4>(
        DZ, C, hc, [&](int c) { return w2 + static_cast<size_t>(c) * hidden + j0; },
        [&](int o, int t, float v0, float v1) {
          float2* ph = reinterpret_cast<float2*>(HP + o * kLd + t);
          const float2 h = *ph;
          const float2 d = make_float2(v0 * gelu_grad(h.x), v1 * gelu_grad(h.y));
          *ph = d;
          *reinterpret_cast<float2*>(HB + o * kLd + t) =
              make_float2(round_to<T>(d.x), round_to<T>(d.y));
        }, stages);
    __syncthreads();
    row_sums(hc, [&](int j, int t) { return HP[j * kLd + t]; },
             [&](int j, float v) { atomicAdd(db1 + j0 + j, v); });
    // dW1[j0 + j][c] += sum_t dhpre[j][t] LN(x)[c][t]
    gemm_tok<6, 6>(HB, hc, XN, C, [&](int j, int c, float v) {
      atomicAdd(dw1 + static_cast<size_t>(j0 + j) * C + c, v);
    });
    // dL/d LN(x) += dhpre W1[chunk, :]
    gemm_wt<T, 4>(
        HB, hc, C, [&](int j) { return w1 + static_cast<size_t>(j0 + j) * C; },
        [&](int o, int t, float v0, float v1) {
          float2* pd = reinterpret_cast<float2*>(D + o * kLd + t);
          const float2 d = *pd;
          *pd = make_float2(d.x + v0, d.y + v1);
        }, stages);
    __syncthreads();
  }

  for (int e = threadIdx.x; e < kTok * C; e += kThreads) {
    const int t = e / C, c = e % C;
    XN[c * kLd + t] = t < n ? to_f32(x[static_cast<size_t>(tok0 + t) * C + c]) : 0.f;
  }
  __syncthreads();
  layer_norm_backward(XN, D, C, p.ln_w, stats, p.dln_w, p.dln_b);
  for (int e = threadIdx.x; e < n * C; e += kThreads) {
    const int t = e / C, c = e % C;
    const size_t g = static_cast<size_t>(tok0 + t) * C + c;
    float v = D[c * kLd + t];
    if (p.mode != kBranch) v += to_f32(dz[g]);
    dx[g] = from_f32<T>(v);
  }
}

size_t smem_bytes(int channels) {
  return static_cast<size_t>(stage_offset(channels)) * sizeof(float) +
         kStageElems * sizeof(float);
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.channels);
  cudaError_t err = cudaFuncSetAttribute(mlp_block_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (p.tokens + kTok - 1) / kTok;
  mlp_block_bwd_kernel<T><<<blocks, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one thread block takes, in bytes.
size_t mlp_block_bwd_smem_bytes(int channels) { return smem_bytes(channels); }

// Number of floats in the gradient buffer: d ln_w (C), d ln_b (C),
// d W1 (hidden * C), d b1 (hidden), d W2 (C * hidden), d b2 (C), in this order.
size_t mlp_block_bwd_grad_floats(int channels, int hidden) {
  return 3 * static_cast<size_t>(channels) + hidden + 2 * static_cast<size_t>(channels) * hidden;
}

// dtype: 0 float32, 1 bfloat16; mode: 0 branch, 1 branch + x, 2 s * branch + x.
// Zeroes `grads` on the stream, then launches. Returns the cudaError_t (0 on success).
int mlp_block_bwd(int dtype, const void* x, const void* dz, void* dx, int tokens, int channels,
                  int hidden, int tokens_per_sample, const float* ln_w, const float* ln_b,
                  const void* w1, const float* b1, const void* w2, int mode, const float* s,
                  float* grads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t C = channels, H = hidden;
  cudaError_t err =
      cudaMemsetAsync(grads, 0, mlp_block_bwd_grad_floats(channels, hidden) * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* dln_w = grads;
  float* dln_b = dln_w + C;
  float* dw1 = dln_b + C;
  float* db1 = dw1 + H * C;
  float* dw2 = db1 + H;
  float* db2 = dw2 + C * H;
  const Params p{x, dz, dx, tokens, channels, hidden, tokens_per_sample, ln_w, ln_b,
                 w1, b1, w2, mode, s, dln_w, dln_b, dw1, db1, dw2, db2};
  if (dtype == 0) return launch<float>(p, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mlp_block_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
