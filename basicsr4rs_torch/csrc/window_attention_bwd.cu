// Windowed multi-head attention from packed q|k|v, backward: one thread
// block per (window position, head), walking over a group of samples.
//
// Replaces basicsr4rs_tpu/ops/window_attention.py::_attention_bwd_kernel.
// From qkv (B, H, W, 3C), the float32 bias (nWb, heads, n, n) and the output
// cotangent dout (B, H, W, C) alone it recomputes P = softmax(scale q k^T +
// bias) and emits
//
//   dV = P^T dO      dP = dO V^T      dS = P * (dP - rowsum(dP * P))
//   dQ = scale dS K  dK = scale dS^T Q
//
// as dqkv (B, H, W, 3C) in qkv's dtype, and dbias (nWb, heads, n, n) in
// float32: the sum of dS over the samples, and over the windows too when
// nWb == 1. P and dS are rounded to the model dtype where they feed the
// second product of a chain; the softmax backward and dbias stay float32.
//
// What bounds it on an H100: 4C values in and 3C out a token for 10 n C
// FLOP (C=192, n=64: 5.4 KB against 123 kFLOP in float32, 23 FLOP a byte at
// a float32 balance of 20): operations in float32, narrowly, and bytes in
// bfloat16. As in the forward every input is read once by window addressing
// and every output written once into its place. Two things shape it.
// - dbias is a sum across thread blocks. The TPU kernel keeps it resident
//   over a sequential grid; here a block walks over `samples_per_block`
//   samples at one window position, keeps the sum of its own dS entries in
//   registers, and adds it once into the zeroed float32 dbias with
//   atomicAdd. The group is chosen so that the grid still fills the card.
//   The order of those adds, hence dbias's last bits, changes from run to
//   run whenever more than one block adds into an entry.
// - The softmax backward needs rowsum(dP * P). A thread owns a 4 x 4 patch
//   of the n x n tile for scores, P, dP and dS alike, so the row sums are a
//   shuffle reduction over the 16 lanes that share a row, dP never leaves
//   registers, and dS replaces P in shared memory in place.

#include <algorithm>

#include "window_attention.cuh"

namespace {

using namespace wattn;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    window_attention_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                                const T* __restrict__ dout, T* __restrict__ dqkv,
                                float* __restrict__ dbias, const Geometry g,
                                const int samples_per_block) {
  extern __shared__ float smem[];
  const int C = g.channels, ws = g.window, n = ws * ws, hd = C / g.heads;
  const int ld = head_stride(hd), lds = score_stride(n);
  float* Q = smem;  // q * scale
  float* K = Q + n * ld;
  float* V = K + n * ld;
  float* DO = V + n * ld;
  float* S = DO + n * ld;  // scores, then P, then dS

  const int nw = (g.height / ws) * (g.width / ws);
  const int win = blockIdx.x % nw, h = blockIdx.y;
  const int first = (blockIdx.x / nw) * samples_per_block;
  const int last = min(g.batch, first + samples_per_block);
  const float scale = g.scale;
  const int slot = g.bias_windows == 1 ? 0 : win;
  const size_t bias_at = (static_cast<size_t>(slot) * g.heads + h) * n * n;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  float ds_sum[kTile][kTile];
#pragma unroll
  for (int a = 0; a < kTile; ++a)
#pragma unroll
    for (int b = 0; b < kTile; ++b) ds_sum[a][b] = 0.f;

  for (int img = first; img < last; ++img) {
    __syncthreads();  // the previous sample's products have read the buffers
    load_head(Q, qkv, g, img, win, 3 * C, h * hd, n, hd,
              [&](float v) { return round_to<T>(v * scale); });
    load_head(K, qkv, g, img, win, 3 * C, C + h * hd, n, hd, [](float v) { return v; });
    load_head(V, qkv, g, img, win, 3 * C, 2 * C + h * hd, n, hd, [](float v) { return v; });
    load_head(DO, dout, g, img, win, C, h * hd, n, hd, [](float v) { return v; });
    __syncthreads();

    float acc[kTile][kTile];
    tile_dot(Q, K, n, hd, acc);
    store_scores(S, acc, bias + bias_at, n);
    __syncthreads();
    softmax_rows(S, n);
    __syncthreads();

    // dV = P^T dO
    row_product<T, true>(S, DO, n, hd, [&](int j, int d, float v) {
      dqkv[token_offset(g, img, win, j, 3 * C) + 2 * C + h * hd + d] = from_f32<T>(v);
    });

    // dP in registers; delta_i = sum_j dP[i][j] P[i][j] over the 16 lanes of a row
    tile_dot(DO, V, n, hd, acc);
    float p[kTile][kTile], delta[kTile];
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
      float part = 0.f;
#pragma unroll
      for (int b = 0; b < kTile; ++b) {
        const int i = ty + 16 * a, j = tx + 16 * b;
        p[a][b] = (i < n && j < n) ? S[i * lds + j] : 0.f;
        part = fmaf(acc[a][b], p[a][b], part);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      delta[a] = part;
    }
    __syncthreads();  // dV has read P
#pragma unroll
    for (int a = 0; a < kTile; ++a)
#pragma unroll
      for (int b = 0; b < kTile; ++b) {
        const int i = ty + 16 * a, j = tx + 16 * b;
        if (i < n && j < n) {
          const float ds = p[a][b] * (acc[a][b] - delta[a]);
          S[i * lds + j] = ds;
          ds_sum[a][b] += ds;
        }
      }
    __syncthreads();

    // dQ = scale dS K
    row_product<T, false>(S, K, n, hd, [&](int i, int d, float v) {
      dqkv[token_offset(g, img, win, i, 3 * C) + h * hd + d] = from_f32<T>(scale * v);
    });
    // dK = dS^T (scale q)
    row_product<T, true>(S, Q, n, hd, [&](int j, int d, float v) {
      dqkv[token_offset(g, img, win, j, 3 * C) + C + h * hd + d] = from_f32<T>(v);
    });
  }

  float* db = dbias + bias_at;
#pragma unroll
  for (int a = 0; a < kTile; ++a)
#pragma unroll
    for (int b = 0; b < kTile; ++b) {
      const int i = ty + 16 * a, j = tx + 16 * b;
      if (i < n && j < n) atomicAdd(db + i * n + j, ds_sum[a][b]);
    }
}

size_t smem_bytes(int channels, int heads, int window) {
  const int n = window * window, hd = channels / heads;
  return static_cast<size_t>(4 * n * head_stride(hd) + n * score_stride(n)) * sizeof(float);
}

// Samples one block walks over: as many as leave the grid about eight
// blocks for each of an H100's 132 SMs, at most the batch.
int samples_per_block(int batch, int windows, int heads) {
  const long long blocks = static_cast<long long>(batch) * windows * heads;
  const int group = static_cast<int>(std::min<long long>(batch, std::max<long long>(1, blocks / 1056)));
  const int chunks = (batch + group - 1) / group;
  return (batch + chunks - 1) / chunks;
}

template <typename T>
int launch(const void* qkv, const float* bias, const void* dout, void* dqkv, float* dbias,
           const Geometry& g, cudaStream_t stream) {
  const size_t smem = smem_bytes(g.channels, g.heads, g.window);
  cudaError_t err = cudaFuncSetAttribute(window_attention_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int windows = (g.height / g.window) * (g.width / g.window);
  const int group = samples_per_block(g.batch, windows, g.heads);
  const dim3 grid(windows * ((g.batch + group - 1) / group), g.heads);
  window_attention_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), bias, static_cast<const T*>(dout), static_cast<T*>(dqkv), dbias,
      g, group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one thread block takes, in bytes.
size_t window_attention_bwd_smem_bytes(int channels, int heads, int window) {
  return smem_bytes(channels, heads, window);
}

// dtype: 0 float32, 1 bfloat16 (qkv, dout and dqkv); bias and dbias are
// float32 (bias_windows, heads, n, n). Zeroes dbias on the stream, then
// launches. Returns the cudaError_t (0 on success).
int window_attention_bwd(int dtype, const void* qkv, const float* bias, const void* dout,
                         void* dqkv, float* dbias, int batch, int height, int width, int channels,
                         int heads, int window, int bias_windows, float scale, void* stream) {
  if (window * window > kMaxTokens || channels / heads > kMaxHeadDim)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = static_cast<size_t>(window) * window;
  cudaError_t err = cudaMemsetAsync(dbias, 0, bias_windows * heads * n * n * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Geometry g{batch, height, width, channels, heads, window, bias_windows, scale};
  if (dtype == 0) return launch<float>(qkv, bias, dout, dqkv, dbias, g, st);
  if (dtype == 1) return launch<__nv_bfloat16>(qkv, bias, dout, dqkv, dbias, g, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* window_attention_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
