// Windowed multi-head attention from packed q|k|v, forward: one thread block
// per (window, head).
//
// Replaces basicsr4rs_tpu/ops/window_attention.py::_attention_kernel. For
// qkv (B, H, W, 3C) and a float32 bias (nWb, heads, n, n), nWb 1 or the
// windows of one image, it writes
//
//   out[window, head] = softmax(scale * q k^T + bias) v        (B, H, W, C)
//
// with the softmax in float32 and P rounded to the model dtype before P v.
// The qkv and proj GEMMs stay outside, as in the TPU kernel.
//
// What bounds it on an H100: bytes. A token brings 3C values in and takes C
// out for 4 n C FLOP (C=192, n=64: 3 KB against 49 kFLOP in float32, 16
// FLOP a byte where the card's float32 balance is 20). The design keeps the
// traffic at that minimum: q, k and v are read once, straight from the
// (B, H, W, 3C) layout by window addressing (128 contiguous bytes a token
// and head at head_dim 32), scores and probabilities stay in shared memory,
// and the output is written once into its (B, H, W, C) place, so there is
// no window partition or reverse copy. One block per (window, head) rather
// than per window gives `heads` times the blocks: a single 8x8 map still
// spreads over 6 SMs, and at about 42 KB of shared memory a block several
// blocks share an SM. The TPU kernel's window packing and its -1e9
// cross-window mask have no counterpart.

#include "window_attention.cuh"

namespace {

using namespace wattn;

template <typename T, int kTile>
__global__ void __launch_bounds__(kThreads)
    window_attention_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                                T* __restrict__ out, const Geometry g) {
  extern __shared__ float smem[];
  const int C = g.channels, ws = g.window, n = ws * ws, hd = C / g.heads;
  const int ld = head_stride(hd);
  float* Q = smem;  // q * scale
  float* K = Q + n * ld;
  float* V = K + n * ld;
  float* S = V + n * ld;  // scores, then P

  const int nw = (g.height / ws) * (g.width / ws);
  const int img = blockIdx.x / nw, win = blockIdx.x % nw, h = blockIdx.y;
  const float scale = g.scale;

  load_head(Q, qkv, g, img, win, 3 * C, h * hd, n, hd,
            [&](float v) { return round_to<T>(v * scale); });
  load_head(K, qkv, g, img, win, 3 * C, C + h * hd, n, hd, [](float v) { return v; });
  load_head(V, qkv, g, img, win, 3 * C, 2 * C + h * hd, n, hd, [](float v) { return v; });
  __syncthreads();

  float acc[kTile][kTile];
  tile_dot<kTile>(Q, K, n, hd, acc);
  const int slot = g.bias_windows == 1 ? 0 : win;
  store_scores<kTile>(S, acc, bias + (static_cast<size_t>(slot) * g.heads + h) * n * n, n);
  __syncthreads();
  softmax_rows<(16 * kTile + 31) / 32>(S, n);
  __syncthreads();
  row_product<T>(S, V, n, hd, [&](int i, int d, float v) {
    out[token_offset(g, img, win, i, C) + h * hd + d] = from_f32<T>(v);
  });
}

size_t smem_bytes(int channels, int heads, int window) {
  const int n = window * window, hd = channels / heads;
  return static_cast<size_t>(3 * n * head_stride(hd) + n * score_stride(n)) * sizeof(float);
}

template <typename T, int kTile>
int launch(const void* qkv, const float* bias, void* out, const Geometry& g, cudaStream_t stream) {
  const size_t smem = smem_bytes(g.channels, g.heads, g.window);
  cudaError_t err = cudaFuncSetAttribute(window_attention_fwd_kernel<T, kTile>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.batch * (g.height / g.window) * (g.width / g.window), g.heads);
  window_attention_fwd_kernel<T, kTile><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), bias, static_cast<T*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* qkv, const float* bias, void* out, const Geometry& g, cudaStream_t stream) {
  if (tile_of(g.window * g.window) == 4) return launch<T, 4>(qkv, bias, out, g, stream);
  return launch<T, 6>(qkv, bias, out, g, stream);
}

}  // namespace

extern "C" {

// Shared memory one thread block takes, in bytes.
size_t window_attention_fwd_smem_bytes(int channels, int heads, int window) {
  return smem_bytes(channels, heads, window);
}

// dtype: 0 float32, 1 bfloat16 (qkv and out); bias is float32
// (bias_windows, heads, n, n). Returns the cudaError_t (0 on success).
int window_attention_fwd(int dtype, const void* qkv, const float* bias, void* out, int batch,
                         int height, int width, int channels, int heads, int window,
                         int bias_windows, float scale, void* stream) {
  if (window * window > kMaxTokens || channels / heads > kMaxHeadDim)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{batch, height, width, channels, heads, window, bias_windows, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(qkv, bias, out, g, st);
  if (dtype == 1) return launch<__nv_bfloat16>(qkv, bias, out, g, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* window_attention_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
