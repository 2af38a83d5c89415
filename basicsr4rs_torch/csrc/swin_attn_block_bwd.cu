// Swin attention branch, backward: one thread block per window.
//
// Replaces basicsr4rs_tpu/ops/swin_block.py::_block_bwd_kernel. From x and
// the cotangent dz alone it recomputes LN(x), q/k/v and the attention
// probabilities and emits
//
//   dx, d ln_w, d ln_b, d Wqkv, d bqkv, d Wproj, d bproj, d rel_bias
//
// of  out = z,  z + x  or  s[b] * z + x  with z = proj(W-MSA(LN(x))). The
// branch cotangent is s[b] * dz, the residual cotangent dz itself. The
// relative-position bias (heads, n, n) is shared by every window, so its
// gradient is the sum of the score cotangents over all windows and samples;
// the shift mask gets none. GEMM inputs are rounded to the model dtype,
// every sum is float32.
//
// What bounds it on an H100: compute, about 0.8 MFLOP per token at C=180
// with 6 heads and 8x8 windows. Two things shape it.
// - Weight gradients. The TPU kernel keeps them resident over a sequential
//   grid; thread blocks here run in parallel and d Wqkv alone (389 KB in
//   float32 at C=180) exceeds a block's shared memory, so each block adds
//   its window's partial sums into the zeroed float32 gradient buffer with
//   atomicAdd, lanes along the fastest index. The sum's order, hence its
//   last bits, changes from run to run.
// - Shared memory. A window's LN(x), dz and dL/d LN(x) take three C-row
//   buffers; the rest goes head by head: recompute q, k, v and P of one head,
//   form the attention output (for d Wproj and for delta = dO . O, which
//   gives the softmax backward without keeping dP), dV, dS in place of P, dQ
//   and dK, add dS into d rel_bias, push the head's dq|dk|dv through d Wqkv
//   and dL/d LN(x), and drop it all before the next head. About 224 KB at
//   C=180, one window per SM.

#include "swin_common.cuh"

namespace {

using namespace swin;

struct Params {
  const void* x;
  const void* dz;
  void* dx;
  int batch, height, width, channels, heads, window;
  const float* ln_w;
  const float* ln_b;
  const void* wqkv;  // (3C, C)
  const float* bqkv;
  const void* wproj;  // (C, C)
  const float* rel_bias;  // (heads, n, n)
  const float* mask;      // (nW, n, n) or null
  int mode;
  const float* s;  // (B,) when mode == kScaled
  float scale;
  // float32 gradients, zeroed before the launch
  float* dln_w;
  float* dln_b;
  float* dwqkv;
  float* dbqkv;
  float* dwproj;
  float* dbproj;
  float* drel_bias;
};

// Float offset of the weight stages: after three C-row buffers, five
// head-dim buffers (q, k, v and two more), the scores, the LN statistics and
// delta, 16-byte aligned.
__host__ __device__ inline int stage_offset(int channels, int heads) {
  return ((3 * channels + 5 * (channels / heads) + kTok) * kLd + 3 * kTok + 3) / 4 * 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) swin_attn_block_bwd_kernel(const Params p) {
  extern __shared__ float smem[];
  const int H = p.height, W = p.width, C = p.channels, heads = p.heads;
  const int ws = p.window, n = ws * ws, hd = C / heads;
  const float scale = p.scale;
  const T* x = static_cast<const T*>(p.x);
  const T* dz = static_cast<const T*>(p.dz);
  T* dx = static_cast<T*>(p.dx);
  const T* wqkv = static_cast<const T*>(p.wqkv);
  const T* wproj = static_cast<const T*>(p.wproj);
  float *dwqkv = p.dwqkv, *dbqkv = p.dbqkv, *dwproj = p.dwproj, *dbproj = p.dbproj;

  const int nww = W / ws, nw = (H / ws) * nww;
  const int img = blockIdx.x / nw, win = blockIdx.x % nw;
  const int row0 = (win / nww) * ws, col0 = (win % nww) * ws;
  const float* mask = p.mask ? p.mask + static_cast<size_t>(win) * n * n : nullptr;
  const float s = p.mode == kScaled ? p.s[img] : 1.f;

  float* D = smem;                 // x, then dL/d LN(x), then dx
  float* XN = D + C * kLd;         // LN(x), then x again
  float* DZ = XN + C * kLd;        // the branch cotangent
  float* QKV = DZ + C * kLd;       // q (scaled), k, v of one head
  float* Q = QKV;
  float* K = QKV + hd * kLd;
  float* V = QKV + 2 * hd * kLd;   // v, then dk
  float* T1 = QKV + 3 * hd * kLd;  // the head's attention output, then dv
  float* T2 = QKV + 4 * hd * kLd;  // dO, then dq
  float* S = QKV + 5 * hd * kLd;   // P, then dS, key-major: kTok rows
  float* stats = S + kTok * kLd;
  float* delta = stats + 2 * kTok;
  T* stages = reinterpret_cast<T*>(smem + stage_offset(C, heads));
  float* G = V;  // dk | dv | dq, 3 * hd rows

  // token t of the window sits at row row0 + t / ws, column col0 + t % ws
  auto offset = [&](int t) {
    return ((static_cast<size_t>(img) * H + row0 + t / ws) * W + col0 + t % ws) * C;
  };

  for (int e = threadIdx.x; e < kTok * C; e += kThreads) {
    const int t = e / C, c = e % C;
    float xv = 0.f, dv = 0.f;
    if (t < n) {
      const size_t g = offset(t) + c;
      xv = to_f32(x[g]);
      dv = to_f32(dz[g]) * s;
    }
    D[c * kLd + t] = xv;
    DZ[c * kLd + t] = dv;
  }
  // rows and columns of S beyond n are never written below: keep them finite
  if (n < kTok)
    for (int e = threadIdx.x; e < kTok * kLd; e += kThreads) S[e] = 0.f;
  __syncthreads();
  layer_norm<T>(D, XN, C, p.ln_w, p.ln_b, stats);
  row_sums(C, [&](int c, int t) { return DZ[c * kLd + t]; },
           [&](int c, float v) { atomicAdd(dbproj + c, v); });
  __syncthreads();
  for (int e = threadIdx.x; e < C * kLd; e += kThreads) {
    D[e] = 0.f;
    DZ[e] = round_to<T>(DZ[e]);
  }
  __syncthreads();

  for (int h = 0; h < heads; ++h) {
    // row of Wqkv behind row r of G = dk | dv | dq
    auto g_row = [&](int r) { return ((r / hd + 1) % 3) * C + h * hd + r % hd; };
    float* drel = p.drel_bias + static_cast<size_t>(h) * n * n;

    head_qkv<T>(XN, QKV, C, hd, h, wqkv, p.bqkv, scale, stages);
    __syncthreads();
    head_probs<T>(QKV, S, hd, n, p.rel_bias + static_cast<size_t>(h) * n * n, mask);
    // T1 = O = P v, the head's attention output
    gemm_s<2>(
        S, n, hd, [&](int d, int j) { return V[d * kLd + j]; },
        [&](int d, int t, float v0, float v1) {
          *reinterpret_cast<float2*>(T1 + d * kLd + t) =
              make_float2(round_to<T>(v0), round_to<T>(v1));
        });
    // T2 = dO = dz Wproj[:, head]
    gemm_wt<T, 2>(
        DZ, C, hd, [&](int o) { return wproj + static_cast<size_t>(o) * C + h * hd; },
        [&](int d, int t, float v0, float v1) {
          *reinterpret_cast<float2*>(T2 + d * kLd + t) =
              make_float2(round_to<T>(v0), round_to<T>(v1));
        }, stages);
    __syncthreads();
    {  // delta[i] = sum_d dO[d][i] O[d][i] = sum_j dP[i][j] P[i][j]
      const int i = threadIdx.x / kPerTok, part = threadIdx.x % kPerTok;
      float acc = 0.f;
      for (int d = part; d < hd; d += kPerTok) acc += T2[d * kLd + i] * T1[d * kLd + i];
      acc = token_sum(acc);
      if (part == 0) delta[i] = acc;
    }
    // dWproj[o][head, d] += sum_t dz[o][t] O[d][t]
    gemm_tok<12, 1>(DZ, C, T1, hd, [&](int o, int d, float v) {
      atomicAdd(dwproj + static_cast<size_t>(o) * C + h * hd + d, v);
    });
    __syncthreads();
    // T1 = dv: dv[d][j] = sum_i dO[d][i] P[i][j]
    gemm_tok<2, 2>(T2, hd, S, kTok, [&](int d, int j, float v) { T1[d * kLd + j] = v; });
    __syncthreads();
    // dS in place of P: dP[i][j] = sum_d dO[d][i] v[d][j], dS = P (dP - delta)
    gemm_s<4>(
        T2, hd, n, [&](int j, int d) { return V[d * kLd + j]; },
        [&](int j, int i, float v0, float v1) {
          float2* ps = reinterpret_cast<float2*>(S + j * kLd + i);
          const float2 pv = *ps;
          *ps = make_float2(pv.x * (v0 - delta[i]), pv.y * (v1 - delta[i + 1]));
        });
    __syncthreads();
    for (int e = threadIdx.x; e < n * n; e += kThreads) {
      float* ps = S + (e % n) * kLd + e / n;
      atomicAdd(drel + e, *ps);
      *ps = round_to<T>(*ps);
    }
    __syncthreads();
    // T2 = dq = scale * dS k
    gemm_s<2>(
        S, n, hd, [&](int d, int j) { return K[d * kLd + j]; },
        [&](int d, int i, float v0, float v1) {
          *reinterpret_cast<float2*>(T2 + d * kLd + i) = make_float2(scale * v0, scale * v1);
        });
    // V = dk: dk[d][j] = sum_i dS[i][j] (scale q)[d][i]
    gemm_tok<2, 2>(Q, hd, S, kTok, [&](int d, int j, float v) { V[d * kLd + j] = v; });
    __syncthreads();
    row_sums(3 * hd, [&](int r, int t) { return G[r * kLd + t]; },
             [&](int r, float v) { atomicAdd(dbqkv + g_row(r), v); });
    __syncthreads();
    if constexpr (sizeof(T) != sizeof(float)) {
      for (int e = threadIdx.x; e < 3 * hd * kLd; e += kThreads) G[e] = round_to<T>(G[e]);
      __syncthreads();
    }
    // dWqkv[row][c] += sum_t dqkv[row][t] LN(x)[c][t]
    gemm_tok<6, 6>(G, 3 * hd, XN, C, [&](int r, int c, float v) {
      atomicAdd(dwqkv + static_cast<size_t>(g_row(r)) * C + c, v);
    });
    // dL/d LN(x) += dqkv Wqkv[head rows, :]
    gemm_wt<T, 4>(
        G, 3 * hd, C, [&](int r) { return wqkv + static_cast<size_t>(g_row(r)) * C; },
        [&](int o, int t, float v0, float v1) {
          float2* pd = reinterpret_cast<float2*>(D + o * kLd + t);
          const float2 d = *pd;
          *pd = make_float2(d.x + v0, d.y + v1);
        }, stages);
    __syncthreads();
  }

  for (int e = threadIdx.x; e < kTok * C; e += kThreads) {
    const int t = e / C, c = e % C;
    XN[c * kLd + t] = t < n ? to_f32(x[offset(t) + c]) : 0.f;
  }
  __syncthreads();
  layer_norm_backward(XN, D, C, p.ln_w, stats, p.dln_w, p.dln_b);
  for (int e = threadIdx.x; e < n * C; e += kThreads) {
    const int t = e / C, c = e % C;
    const size_t g = offset(t) + c;
    float v = D[c * kLd + t];
    if (p.mode != kBranch) v += to_f32(dz[g]);
    dx[g] = from_f32<T>(v);
  }
}

size_t smem_bytes(int channels, int heads) {
  return static_cast<size_t>(stage_offset(channels, heads)) * sizeof(float) +
         kStageElems * sizeof(float);
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.channels, p.heads);
  cudaError_t err = cudaFuncSetAttribute(swin_attn_block_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = p.batch * (p.height / p.window) * (p.width / p.window);
  swin_attn_block_bwd_kernel<T><<<blocks, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one thread block takes, in bytes.
size_t swin_attn_block_bwd_smem_bytes(int channels, int heads) {
  return smem_bytes(channels, heads);
}

// Number of floats in the gradient buffer: d ln_w (C), d ln_b (C),
// d Wqkv (3C * C), d bqkv (3C), d Wproj (C * C), d bproj (C),
// d rel_bias (heads * n * n), in this order.
size_t swin_attn_block_bwd_grad_floats(int channels, int heads, int window) {
  const size_t C = channels, n = static_cast<size_t>(window) * window;
  return 6 * C + 4 * C * C + heads * n * n;
}

// dtype: 0 float32, 1 bfloat16; mode: 0 branch, 1 branch + x, 2 s * branch + x.
// Zeroes `grads` on the stream, then launches. Returns the cudaError_t (0 on success).
int swin_attn_block_bwd(int dtype, const void* x, const void* dz, void* dx, int batch, int height,
                        int width, int channels, int heads, int window, const float* ln_w,
                        const float* ln_b, const void* wqkv, const float* bqkv,
                        const void* wproj, const float* rel_bias, const float* mask, int mode,
                        const float* s, float scale, float* grads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t C = channels;
  cudaError_t err = cudaMemsetAsync(
      grads, 0, swin_attn_block_bwd_grad_floats(channels, heads, window) * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* dln_w = grads;
  float* dln_b = dln_w + C;
  float* dwqkv = dln_b + C;
  float* dbqkv = dwqkv + 3 * C * C;
  float* dwproj = dbqkv + 3 * C;
  float* dbproj = dwproj + C * C;
  float* drel_bias = dbproj + C;
  const Params p{x,     dz,    dx,       batch, height, width, channels, heads,  window,
                 ln_w,  ln_b,  wqkv,     bqkv,  wproj,  rel_bias, mask,  mode,   s,
                 scale, dln_w, dln_b,    dwqkv, dbqkv,  dwproj,   dbproj, drel_bias};
  if (dtype == 0) return launch<float>(p, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* swin_attn_block_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
