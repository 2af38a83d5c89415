// 3x3, stride 1, zero-padded ("same") convolution with its epilogue, forward,
// as an implicit GEMM on the tensor cores.
//
// Replaces basicsr4rs_tpu/ops/conv3x3.py::_conv_kernel (the Pallas kernel
// behind fused_conv3x3). For x channels-last (B, H, W, Cin) and the weight
// channels-last, (Cout, 3, 3, Cin) in memory, it computes
//
//   out = conv3x3(x, w) + bias (+ residual), then leaky_relu(out, slope) if asked,
//
// with float32 sums, and writes out channels-last (B, H, W, Cout) in x's
// type (float32 or bfloat16), rounded once. The residual is channels-last
// too. Any H, W, Cin and Cout: ragged tiles, channels and output channels
// are masked, the halo outside the map reads as zero.
//
// What bounds it on an H100: operations. SwinIR-M's 180 -> 180 conv on a
// 128x128 map is 9.6 GFLOP against 4.7 MB of activations and 1.2 MB of
// weights. The GEMM is M = output pixels, N = Cout, K = 9 taps x Cin. A
// block owns 8 x 16 output pixels (M = 128) and 64, 128 or 192 output
// channels (N: all of SwinIR-M's 180 in one block, so each halo is staged
// once), 16 warps as 4 along M (two output rows each) by 4 along N, so that
// a thread's accumulators (at most 2 x 6 n8 tiles) fit its 128 registers.
// Cin is walked in K steps of 32 bytes (8 float32 or 16 bfloat16 channels):
// for each step the 10 x 18 halo tile of x and the (9, N) weight rows are
// copied into shared memory by cp.async (zero-filled where masked), in rows
// of 32 bytes whose two 16-byte halves swap every fourth row (so that
// ldmatrix's eight rows fall in eight bank groups), so that later steps
// load while this one multiplies; the nine taps read the one halo tile as
// views shifted by whole pixel rows (the JAX kernel's idea of taps as
// shifted views of one staged image). Fragments come from shared memory by
// ldmatrix and go to mma.sync: m16n8k16 bfloat16 (three stages), or for
// float32 three m16n8k8 TF32 products (3xTF32: each operand split as hi =
// tf32(a), lo = tf32(a - hi), and hi*hi + hi*lo + lo*hi summed in float32,
// about 2^-21 relative per product; plain TF32, 2^-11, would leave the
// float32 tolerance). The split is made once a step, for the whole stage,
// into hi in place and lo beside it (two stages and the lo plane), not by
// every warp for every fragment it reads: conversions are slow. mma.sync
// rather than wgmma: a tap's shifted view starts at any pixel row of the
// halo, which ldmatrix takes as it is. The epilogue runs on the accumulators
// in registers: bias, residual, leaky-ReLU, one rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kTileH = 8, kTileW = 16;    // output pixels of a block: M = 128
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloPixels = (kTileH + 2) * kHaloW;
constexpr int kStepBytes = 32;            // one K step of a pixel or an output channel: a row

template <int NT>   // n8 tiles of a warp; a block has four warps along N
struct Tiles {
  static constexpr int kBlockN = 4 * NT * 8;
  static constexpr int kWeightBytes = 9 * kBlockN * kStepBytes;
  static constexpr int kStageBytes = kWeightBytes + kHaloPixels * kStepBytes;
  // three buffers in both types: bfloat16 three stages, float32 two and the lo plane
  static constexpr int kSmemBytes = 3 * kStageBytes;
};

template <typename T>
constexpr int kStagesOf = sizeof(T) == 4 ? 2 : 3;

struct Params {
  const void* x;         // (B, H, W, Cin)
  const void* w;         // (Cout, 3, 3, Cin)
  const float* bias;     // (Cout)
  const void* residual;  // (B, H, W, Cout) or null
  void* out;             // (B, H, W, Cout)
  int batch, cin, cout, height, width;
  int x_copy, w_copy;    // bytes of one copy of x, of the weight: 16, 8, 4, or 0 for one element
  int has_slope;
  float slope;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// cp.async of kBytes, zero-filled where ok is false (nothing is read then)
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool ok) {
  const int n = ok ? kBytes : 0;
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(kBytes), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

using tc::ldmatrix_x4;
using tc::mma_bf16;
using tc::mma_tf32;
using tc::tf32;

// A stage's rows hold one K step (32 bytes) of a weight row (tap, n) or of a
// halo pixel; byte b of row r lies at r * 32 + b with b's 16-byte half
// swapped when bit 2 of r is set.
__device__ __forceinline__ uint32_t swizzle(int row, int byte) {
  return row * kStepBytes + ((((byte >> 4) ^ (row >> 2)) & 1) << 4) + (byte & 15);
}

// kStepBytes of each of `rows` rows into the region at `region` (a shared
// address; `region_ptr` the same as a pointer), `copy` bytes at a time (16,
// 8 or 4; 0: element by element). src(row, element) gives the source of the
// row's element and whether it is in bounds (zero-filled when not).
template <typename T, class Src>
__device__ __forceinline__ void load_rows(int rows, int copy, uint32_t region,
                                          unsigned char* region_ptr, Src src) {
  if (copy == 0) {
    constexpr int kE = kStepBytes / sizeof(T);
    for (int e = threadIdx.x; e < rows * kE; e += kThreads) {
      const int r = e / kE, j = e - r * kE;
      bool ok;
      const T* from = src(r, j, ok);
      *reinterpret_cast<T*>(region_ptr + swizzle(r, j * sizeof(T))) =
          ok ? *from : from_f32<T>(0.f);
    }
    return;
  }
  const int shift = copy == 16 ? 1 : copy == 8 ? 2 : 3;   // log2 of the copies of a row
  const int per = copy / static_cast<int>(sizeof(T));
  for (int e = threadIdx.x; e < rows << shift; e += kThreads) {
    const int r = e >> shift, v = e & ((1 << shift) - 1);
    bool ok;
    const T* from = src(r, v * per, ok);
    const uint32_t dst = region + swizzle(r, v * copy);
    if (copy == 16)
      cp_async<16>(dst, from, ok);
    else if (copy == 8)
      cp_async<8>(dst, from, ok);
    else
      cp_async<4>(dst, from, ok);
  }
}

// One K step (channels c0 .. c0 + 32 bytes) of the block's weight rows and
// halo tile into a stage.
template <typename T, int NT>
__device__ __forceinline__ void load_step(const Params& p, uint32_t stage, unsigned char* stage_ptr,
                                          int b, int y0, int x0, int n0, int c0) {
  constexpr int kBlockN = Tiles<NT>::kBlockN;
  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w);
  load_rows<T>(9 * kBlockN, p.w_copy, stage, stage_ptr, [&](int r, int j, bool& ok) {
    const int tap = r / kBlockN, n = n0 + r - tap * kBlockN, c = c0 + j;
    ok = n < p.cout && c < p.cin;
    return ok ? w + (static_cast<size_t>(n) * 9 + tap) * p.cin + c : w;
  });
  load_rows<T>(kHaloPixels, p.x_copy, stage + Tiles<NT>::kWeightBytes,
               stage_ptr + Tiles<NT>::kWeightBytes, [&](int i, int j, bool& ok) {
    const int hy = i / kHaloW, hx = i - hy * kHaloW;
    const int gy = y0 + hy - 1, gx = x0 + hx - 1, c = c0 + j;
    ok = gy >= 0 && gy < p.height && gx >= 0 && gx < p.width && c < p.cin;
    return ok ? x + static_cast<size_t>((b * p.height + gy) * p.width + gx) * p.cin + c : x;
  });
}

// 3xTF32: every float of a stage split into hi (in place) and lo (at `lo`)
template <int NT>
__device__ __forceinline__ void split_stage(float* stage, float* lo) {
  for (int e = threadIdx.x; e < Tiles<NT>::kStageBytes / 16; e += kThreads) {
    float4 v = reinterpret_cast<float4*>(stage)[e], l;
    float* f = &v.x;
    float* g = &l.x;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float hi = __uint_as_float(tf32(f[r]));
      g[r] = __uint_as_float(tf32(f[r] - hi));
      f[r] = hi;
    }
    reinterpret_cast<float4*>(stage)[e] = v;
    reinterpret_cast<float4*>(lo)[e] = l;
  }
}

template <typename T>
__device__ __forceinline__ float epilogue(const Params& p, const T* residual, size_t at, int n,
                                          float v) {
  v += __ldg(p.bias + n);
  if (residual) v += to_f32(residual[at]);
  if (p.has_slope && v < 0.f) v *= p.slope;
  return v;
}

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 1) conv3x3_fwd_kernel(const Params p) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kStages = kStagesOf<T>;
  constexpr int kBlockN = Tiles<NT>::kBlockN, kE = kStepBytes / sizeof(T);
  constexpr int kStage = Tiles<NT>::kStageBytes;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t smem_at = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t lo_at = smem_at + kStages * kStage;   // float32: the lo plane

  const int tiles_w = (p.width + kTileW - 1) / kTileW;
  const int tiles = tiles_w * ((p.height + kTileH - 1) / kTileH);
  const int b = blockIdx.x / tiles, tile = blockIdx.x - b * tiles;
  const int y0 = tile / tiles_w * kTileH, x0 = (tile % tiles_w) * kTileW;
  const int n0 = blockIdx.y * kBlockN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 3, wn = warp >> 2;   // 4 x 4 warps
  // ldmatrix rows. A (16 pixels x 8 words): lanes 0-15 give pixels 0-15 at
  // words 0-3, lanes 16-31 the same pixels at words 4-7, so the four
  // matrices are a0..a3 of the m16 fragment in both types. B (8 words x 16
  // channels): lanes 0-7 / 8-15 give channels 0-7 at words 0-3 / 4-7 (b0, b1
  // of the first n8 tile), lanes 16-31 channels 8-15 (the second). A B tile
  // starts at a multiple of 8 rows, so its swizzle is the lane's own.
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const uint32_t b_lane = swizzle(b_row, ((lane >> 3) & 1) * 16);
  const int a_half = (lane >> 4) * 16;

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int steps = (p.cin + kE - 1) / kE;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps)
      load_step<T, NT>(p, smem_at + s * kStage, smem + s * kStage, b, y0, x0, n0, s * kE);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();   // step s has landed
    __syncthreads();                // and step s - 1's stage and the lo plane are free
    if (s + kStages - 1 < steps) {
      const int next = (s + kStages - 1) % kStages;
      load_step<T, NT>(p, smem_at + next * kStage, smem + next * kStage, b, y0, x0, n0,
                       (s + kStages - 1) * kE);
    }
    cp_async_commit();
    const int cur = s % kStages;
    const uint32_t weights = smem_at + cur * kStage;
    const uint32_t halo = weights + Tiles<NT>::kWeightBytes;
    if constexpr (kF32) {
      split_stage<NT>(reinterpret_cast<float*>(smem + cur * kStage),
                      reinterpret_cast<float*>(smem + kStages * kStage));
      __syncthreads();
    }
    const uint32_t lo = lo_at - weights;   // from a hi address to its lo twin
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      // every fragment of the tap first (ldmatrix and mma are issued in
      // program order), so that a warp waits on shared memory once a tap
      uint32_t a_at[2], b_at[NT / 2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = (wm * 2 + i + dy) * kHaloW + dx + (lane & 15);
        a_at[i] = halo + swizzle(row, a_half);
      }
#pragma unroll
      for (int j = 0; j < NT / 2; ++j)
        b_at[j] = weights + (tap * kBlockN + (wn * NT + 2 * j) * 8) * kStepBytes + b_lane;
      uint32_t a[2][4], bw[NT / 2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldmatrix_x4(a[i], a_at[i]);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) ldmatrix_x4(bw[j], b_at[j]);
      if constexpr (kF32) {
        // term by term, the small products first, each lo fragment loaded
        // just before its term (fewer registers live); neighbouring
        // products update different accumulators
        {
          uint32_t al[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) ldmatrix_x4(al[i], a_at[i] + lo);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < NT / 2; ++j) {
              mma_tf32(acc[i][2 * j], al[i], bw[j][0], bw[j][1]);
              mma_tf32(acc[i][2 * j + 1], al[i], bw[j][2], bw[j][3]);
            }
        }
        {
          uint32_t bl[NT / 2][4];
#pragma unroll
          for (int j = 0; j < NT / 2; ++j) ldmatrix_x4(bl[j], b_at[j] + lo);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < NT / 2; ++j) {
              mma_tf32(acc[i][2 * j], a[i], bl[j][0], bl[j][1]);
              mma_tf32(acc[i][2 * j + 1], a[i], bl[j][2], bl[j][3]);
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < NT / 2; ++j) {
            mma_tf32(acc[i][2 * j], a[i], bw[j][0], bw[j][1]);
            mma_tf32(acc[i][2 * j + 1], a[i], bw[j][2], bw[j][3]);
          }
      } else {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < NT / 2; ++j) {
            mma_bf16(acc[i][2 * j], a[i], bw[j][0], bw[j][1]);
            mma_bf16(acc[i][2 * j + 1], a[i], bw[j][2], bw[j][3]);
          }
      }
    }
  }

  // c0, c1: pixel g, channels 2t, 2t + 1; c2, c3: pixel g + 8, the same channels
  const T* residual = static_cast<const T*>(p.residual);
  T* out = static_cast<T*>(p.out);
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (p.cout & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int oy = y0 + wm * 2 + i;
    if (oy >= p.height) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ox = x0 + g + 8 * h;
      if (ox >= p.width) continue;
      const size_t row = static_cast<size_t>((b * p.height + oy) * p.width + ox) * p.cout;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + (wn * NT + j) * 8 + 2 * t;
        if (n >= p.cout) continue;
        const float v0 = epilogue(p, residual, row + n, n, acc[i][j][2 * h]);
        if (pairs) {   // n + 1 < Cout, and row + n is even
          const float v1 = epilogue(p, residual, row + n + 1, n + 1, acc[i][j][2 * h + 1]);
          if constexpr (kF32)
            *reinterpret_cast<float2*>(out + row + n) = make_float2(v0, v1);
          else
            *reinterpret_cast<__nv_bfloat162*>(out + row + n) = __floats2bfloat162_rn(v0, v1);
        } else {
          out[row + n] = from_f32<T>(v0);
          if (n + 1 < p.cout)
            out[row + n + 1] = from_f32<T>(epilogue(p, residual, row + n + 1, n + 1,
                                                    acc[i][j][2 * h + 1]));
        }
      }
    }
  }
}

template <typename T, int NT>
int launch(const Params& p, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_fwd_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tiles<NT>::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long tiles = static_cast<long long>((p.height + kTileH - 1) / kTileH) *
                          ((p.width + kTileW - 1) / kTileW) * p.batch;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles),
                  (p.cout + Tiles<NT>::kBlockN - 1) / Tiles<NT>::kBlockN);
  conv3x3_fwd_kernel<T, NT><<<grid, kThreads, Tiles<NT>::kSmemBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(const Params& p, int block_n, cudaStream_t stream) {
  if (block_n == 64) return launch<T, 2>(p, stream);
  if (block_n == 128) return launch<T, 4>(p, stream);
  if (block_n == 192) return launch<T, 6>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. block_n: 64, 128 or 192 output channels a
// block. x_copy, w_copy: the bytes of one copy of x and of the weight (16,
// 8 or 4; 0 element by element, bfloat16 only), dividing Cin's bytes and
// the tensor's alignment. Returns the cudaError_t of the launch (0 on
// success).
int conv3x3_fwd(int dtype, const void* x, const void* w, const float* bias, const void* residual,
                void* out, int batch, int cin, int cout, int height, int width, int block_n,
                int x_copy, int w_copy, int has_slope, float slope, void* stream) {
  const auto copy_ok = [dtype](int c) {
    return c == 16 || c == 8 || c == 4 || (c == 0 && dtype == 1);
  };
  if ((dtype != 0 && dtype != 1) || !copy_ok(x_copy) || !copy_ok(w_copy))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x, w, bias, residual, out, batch, cin, cout, height, width,
                 x_copy, w_copy, has_slope, slope};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_n<float>(p, block_n, s) : launch_n<__nv_bfloat16>(p, block_n, s);
}

// Dynamic shared memory of a block of block_n output channels (0 for
// another block_n).
size_t conv3x3_fwd_smem_bytes(int block_n) {
  if (block_n == 64) return Tiles<2>::kSmemBytes;
  if (block_n == 128) return Tiles<4>::kSmemBytes;
  if (block_n == 192) return Tiles<6>::kSmemBytes;
  return 0;
}

const char* conv3x3_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
