// 3x3, stride 1, zero-padded ("same") convolution with its epilogue, forward.
//
// Replaces basicsr4rs_tpu/ops/conv3x3.py::_conv_kernel (the Pallas kernel
// behind fused_conv3x3). For x (B, Cin, H, W) and weights re-laid by the
// wrapper as (Cin, 3, 3, Cout) it computes, in float32,
//
//   out = conv3x3(x, w) + bias (+ residual), then leaky_relu(out, slope) if asked,
//
// and writes out (B, Cout, H, W) in x's type (float32 or bfloat16). Any H, W,
// Cin and Cout: ragged tiles and channel groups are masked, the halo outside
// the map reads as zero.
//
// What bounds it on an H100: operations. SwinIR-M's 180 -> 180 conv on a
// 128x128 map is 9.6 GFLOP against 4.7 MB of activations and 1.2 MB of
// weights, far above the card's 20 float32 operations per byte. The design is
// a direct convolution on the CUDA cores that keeps the operands of many
// multiply-adds close: a block owns 8 x 32 output pixels x 64 output channels
// and walks Cin in chunks of 8; for each chunk it stages the 10 x 34 halo
// tile of x and the (8, 9, 64) weight slice in shared memory, as float32.
// Lane l of a warp owns column l of the tile for all 8 rows, the warp owns 8
// output channels, so a thread holds an 8 x 8 register tile: per input
// channel and column shift it reads 10 values of x (neighbouring lanes,
// neighbouring addresses) and per tap 8 weights as two 16-byte broadcasts,
// for 64 multiply-adds. Stores are 128-byte rows. Tensor cores
// (an implicit GEMM over wgmma) and a cp.async pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kTileH = 8;    // output rows of a block, all held by each thread
constexpr int kTileW = 32;   // output columns of a block, one per lane
constexpr int kCo = 64;      // output channels of a block
constexpr int kCoT = kCo / (kThreads / 32);  // output channels of a thread
constexpr int kCk = 8;       // input channels per staged chunk
constexpr int kXRow = kTileW + 2;
constexpr int kXRows = kTileH + 2;
constexpr int kXs = kCk * kXRows * kXRow;
constexpr int kWs = kCk * 9 * kCo;
static_assert(kCoT == 8, "a thread reads its weights as two float4");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Params {
  const void* x;         // (B, Cin, H, W)
  const void* w;         // (Cin, 3, 3, Cout)
  const float* bias;     // (Cout)
  const void* residual;  // (B, Cout, H, W) or null
  void* out;             // (B, Cout, H, W)
  int batch, cin, cout, height, width;
  int has_slope;
  float slope;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) conv3x3_fwd_kernel(const Params p) {
  __shared__ float xs[kXs];
  __shared__ __align__(16) float ws[kWs];
  const int Cin = p.cin, Cout = p.cout, H = p.height, W = p.width;
  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w);
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int y0 = (blockIdx.x / tiles_w) * kTileH, x0 = (blockIdx.x % tiles_w) * kTileW;
  const int co0 = blockIdx.y * kCo;
  const size_t b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float acc[kTileH][kCoT];
#pragma unroll
  for (int r = 0; r < kTileH; ++r)
#pragma unroll
    for (int j = 0; j < kCoT; ++j) acc[r][j] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += kCk) {
    for (int e = threadIdx.x; e < kXs; e += kThreads) {
      const int ci = e / (kXRows * kXRow), r = e / kXRow % kXRows, c = e % kXRow;
      const int gc = c0 + ci, gy = y0 + r - 1, gx = x0 + c - 1;
      float v = 0.f;
      if (gc < Cin && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = to_f32(x[((b * Cin + gc) * H + gy) * W + gx]);
      xs[e] = v;
    }
    for (int e = threadIdx.x; e < kWs; e += kThreads) {
      const int r = e / kCo, co = co0 + e % kCo;  // r = ci * 9 + tap
      const int gc = c0 + r / 9;
      ws[e] = gc < Cin && co < Cout ? to_f32(w[(static_cast<size_t>(gc) * 9 + r % 9) * Cout + co])
                                    : 0.f;
    }
    __syncthreads();
    for (int ci = 0; ci < kCk; ++ci) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float xv[kXRows];
#pragma unroll
        for (int r = 0; r < kXRows; ++r) xv[r] = xs[(ci * kXRows + r) * kXRow + lane + dx];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float* wp = ws + (ci * 9 + dy * 3 + dx) * kCo + warp * kCoT;
          const float4 w0 = *reinterpret_cast<const float4*>(wp);
          const float4 w1 = *reinterpret_cast<const float4*>(wp + 4);
          const float wv[kCoT] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int r = 0; r < kTileH; ++r)
#pragma unroll
            for (int j = 0; j < kCoT; ++j) acc[r][j] = fmaf(xv[r + dy], wv[j], acc[r][j]);
        }
      }
    }
    __syncthreads();  // the chunk is overwritten next
  }

  const T* residual = static_cast<const T*>(p.residual);
  T* out = static_cast<T*>(p.out);
  const int gx = x0 + lane;
  if (gx >= W) return;
#pragma unroll
  for (int j = 0; j < kCoT; ++j) {
    const int co = co0 + warp * kCoT + j;
    if (co >= Cout) break;
    const float bias = p.bias[co];
#pragma unroll
    for (int r = 0; r < kTileH; ++r) {
      const int gy = y0 + r;
      if (gy >= H) break;
      const size_t o = ((b * Cout + co) * H + gy) * W + gx;
      float v = acc[r][j] + bias;
      if (residual) v += to_f32(residual[o]);
      if (p.has_slope && v < 0.f) v *= p.slope;
      store(out + o, v);
    }
  }
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const int tiles = ((p.height + kTileH - 1) / kTileH) * ((p.width + kTileW - 1) / kTileW);
  const dim3 grid(tiles, (p.cout + kCo - 1) / kCo, p.batch);
  conv3x3_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. Returns the cudaError_t of the launch (0 on success).
int conv3x3_fwd(int dtype, const void* x, const void* w, const float* bias, const void* residual,
                void* out, int batch, int cin, int cout, int height, int width, int has_slope,
                float slope, void* stream) {
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x, w, bias, residual, out, batch, cin, cout, height, width, has_slope, slope};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* conv3x3_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
