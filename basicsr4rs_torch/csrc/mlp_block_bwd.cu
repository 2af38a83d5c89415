// Transformer MLP branch, backward (K5), every product on the tensor cores.
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
// Bound on an H100: operations. Five products of 2 C hidden FLOP a token
// (5.97 GFLOP at B=4 48x48, C=180, hidden 360): 0.036 ms as 3xTF32 at 495
// TFLOP/s in float32, 0.0060 ms in bfloat16 at 989 (0.089 ms on the CUDA
// cores, this kernel's first route). x, dz and dx move about 20 MB in
// float32 (0.006 ms).
//
// What held the first route back, and what this design does about it:
// 1. Every product ran on the CUDA cores. Now each is an mma.sync
//    (branch_bwd.cuh, as K3's): 3xTF32 m16n8k8 with a truncating split in
//    float32, m16n8k16 in bfloat16, float32 sums. A unit is a tile of 64
//    tokens and a chunk of kChunk hidden columns j (hc <= 96, padded to
//    hcp, a multiple of 16, with zero columns):
//      h = LN(x) W1[chunk]^T + b1     64 x hcp x C     fc1, recomputed
//      dW2[:, chunk] += (s dz)^T g    C x hcp x 64     g = GELU(h)
//      dh = (s dz) W2[:, chunk]       64 x hcp x C
//      dW1[chunk] += dh'^T LN(x)      hcp x C x 64     dh' = dh GELU'(h)
//      dL/dLN(x) += dh' W1[chunk]     64 x C x hcp
//    LN(x), s dz and g (then dh') sit token-major in shared memory, once
//    each: the products over the features read them as they are, the two
//    over the tokens read them transposed (by index in float32, by
//    ldmatrix.trans in bfloat16). W1's chunk rows are read directly for fc1
//    and transposed for dL/dLN(x); W2's chunk columns transposed for dh. h
//    stays in registers from fc1 to dh': a warp owns the same 16 tokens and
//    n8 tiles in both products.
// 2. A tail wave: the first route ran a 64-token tile a block (218 KB of
//    shared memory, one block an SM): 144 tiles on 132 SMs in two waves,
//    55% filled. Now a block takes one (tile, chunk) unit: 576 at SwinIR-M's
//    hidden 360 (chunks 96, 96, 96, 72), one an SM, 576 / (5 x 132) = 87% of
//    the SMs over the kernel's time. Each unit recomputes LN(x) of its tile
//    and adds its partial dL/dLN(x) into a zeroed float32 (tokens, C) buffer;
//    the LayerNorm backward launch of branch_bwd.cuh (K3's) then gives dx
//    (+ dz), d ln_w, d ln_b and d b2 = sum s dz.
// 3. A scalar atomicAdd for every weight-gradient element of every tile (19
//    M a call). Now dW1[chunk] and dW2[:, chunk] are tensor-core products
//    over the unit's tokens whose 16 x 8 tiles leave the block once, as
//    float4 vector reductions, and so does dL/dLN(x). d b1 is summed across
//    a warp's rows by shuffles and across the four token warps in shared
//    memory: one scalar add a column a unit. The sums' order changes from
//    run to run.
// 4. The weight stream: W1[chunk] twice and W2[:, chunk] once a unit (207 KB
//    in float32 at hc = 96) through kStages shared-memory stages by
//    cp.async, the first two stages of each product issued ahead of the
//    work before it. x and dz come in by cp.async too; the LayerNorm
//    parameters and each token's DropPath scale load while they land, and
//    dz lands during fc1.
//
// What holds it back still (ops/joint_block_clock.py --kernel mlp_bwd,
// block 0 at B=4 48x48 on an NVIDIA H100 80GB HBM3 at 700 W): a unit takes
// about 105k cycles in float32 and 66k in bfloat16, and the call (0.305 and
// 0.193 ms) 8.4 and 32 times its 3xTF32 / bf16 bound: like K3, not the
// tensor cores but what surrounds mma.sync at one 16-warp unit an SM
// (fragment loads, transposed float32 reads, the barriers between eight
// dependent phases, epilogues, the copy of x).
// Any hidden and C <= 224 in float32 (shared memory), C <= kMaxC (256) in
// bfloat16 (the LayerNorm launch), with C % 4 == 0 and hidden % 4 == 0:
// every shape the first route held (C <= 196).
//
// Roundings (bfloat16): LN(x), s dz, GELU(h) and dh' are rounded to the
// model dtype; h, dh, GELU' and every sum stay float32.

#include "branch_bwd.cuh"

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
  float* dln;  // (tokens, C) float32 scratch, zeroed: dL/dLN(x) summed over the chunks
};

constexpr int kChunk = 96;   // hidden columns a unit: 3 n8 tiles a warp

// Word offsets of the buffers; P features of the model dtype a word.
struct MlpLayout {
  int ldR, ldH;        // pitches: C features, kChunk features
  int dz, h, stages;   // LN(x) at 0, then s dz, then g / dh'
  int stage_words, red, scale, words;
};

constexpr int kKq = 2 * kKw;   // words of K a stage of fc1 or dh holds

__host__ __device__ inline MlpLayout mlp_layout(int channels, int P) {
  MlpLayout l;
  l.ldR = pitch(channels / P);
  l.ldH = pitch(kChunk / P);
  l.dz = kTok * l.ldR;
  l.h = l.dz + kTok * l.ldR;
  l.stages = l.h + kTok * l.ldH;
  // a stage: kChunk rows of W1 by kKq words (fc1), kKq words of K as rows
  // of the chunk's W2 columns (dh), or kKw words of K as rows of C features
  // (dL/dLN(x))
  l.stage_words = imax(imax(kChunk * (kKq + 4), kKq * P * l.ldH), kKw * P * l.ldR);
  l.red = l.stages + kStages * l.stage_words;
  l.scale = l.red + 4 * kChunk;   // d b1's partial sums: four token warps a column
  l.words = l.scale + kTok;
  return l;
}

size_t mlp_smem_bytes(int dtype, int channels) {
  return static_cast<size_t>(mlp_layout(channels, dtype + 1).words) * 4;
}

// ------------------------------------------------------------------ the unit
// One thread block for hidden chunk blockIdx.x % chunks of token tile
// blockIdx.x / chunks.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) mlp_block_bwd_kernel(const Params p) {
  constexpr Route R = sizeof(T) == 4 ? kTF32x3 : kBF16;
  constexpr int P = 4 / sizeof(T);           // features of T a word
  constexpr int kCopy = P == 1 ? 4 : 2;      // words a cp.async (C, hidden % 4 == 0)
  extern __shared__ __align__(16) uint32_t smem[];

  const int C = p.channels, hidden = p.hidden;
  const int chunks = (hidden + kChunk - 1) / kChunk;
  const int tok0 = blockIdx.x / chunks * kTok, j0 = blockIdx.x % chunks * kChunk;
  const int n = imin(kTok, p.tokens - tok0), hc = imin(kChunk, hidden - j0);
  const int hcp = round_up16(hc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3, m0 = (warp & 3) * 16, wn = warp >> 2;

  const MlpLayout L = mlp_layout(C, P);
  const int ldR = L.ldR, ldH = L.ldH;
  uint32_t* Rb = smem;             // LN(x)
  uint32_t* Zb = smem + L.dz;      // s dz
  uint32_t* Hb = smem + L.h;       // g = GELU(h), then dh'
  uint32_t* stages = smem + L.stages;
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* scale = reinterpret_cast<float*>(smem + L.scale);   // each token's s
  const int Cw = C / P, Hw = hcp / P, Kp = kTok / P;   // words of C, hcp and 64 tokens
  const int Cpad = (Cw + 7) / 8 * 8 * P;   // features a product reads: zero past C

  auto words_of = [](const void* w, size_t element) {
    return reinterpret_cast<const uint32_t*>(static_cast<const T*>(w) + element);
  };
  auto stage = [&](int step) { return stages + (step % kStages) * L.stage_words; };
  const auto fc1_in = [&](int step) {   // rows j of W1[chunk], kKq words of C
    if (step * kKq < Cw) {
      const int kw0 = step * kKq, kn = (imin(kKq, Cw - kw0) + 7) & ~7;
      stage_in<kCopy>(stage(step), kKq + 4, hcp, kn, Cw - kw0,
                      [&, kw0](int r) -> const uint32_t* {
                        return r < hc ? words_of(p.w1, static_cast<size_t>(j0 + r) * C) + kw0
                                      : nullptr;
                      },
                      p.x);
    } else {
      cp_async_commit();
    }
  };
  const auto dh_in = [&](int step) {   // rows c of W2, the chunk's hcp columns
    if (step * kKq < Cw) {
      const int c0 = step * kKq * P;
      stage_in<kCopy>(stage(step), ldH, kKq * P, Hw, hc / P,
                      [&, c0](int r) -> const uint32_t* {
                        const int c = c0 + r;
                        return c < C ? words_of(p.w2, static_cast<size_t>(c) * hidden + j0)
                                     : nullptr;
                      },
                      p.x);
    } else {
      cp_async_commit();
    }
  };
  const auto dln_in = [&](int step) {   // rows j of W1[chunk], C columns
    if (step * kKw < Hw) {
      const int r0 = step * kKw * P;
      stage_in<kCopy>(stage(step), ldR, kKw * P, Cw, Cw,
                      [&, r0](int r) -> const uint32_t* {
                        return r0 + r < hc
                                   ? words_of(p.w1, static_cast<size_t>(j0 + r0 + r) * C)
                                   : nullptr;
                      },
                      p.x);
    } else {
      cp_async_commit();
    }
  };
  // a product's first two stages, issued ahead of the work before it
  auto prefetch = [](auto in) {
    in(0);
    in(1);
  };
  prefetch(fc1_in);
  // cp.async of the n tokens' rows of src into X, zero for the tokens >= n
  // and the features from C to Cpad; one commit group
  auto rows_in = [&](uint32_t* X, const void* src) {
    stage_in<kCopy>(X, ldR, kTok, Cpad / P, Cw, [&](int t) -> const uint32_t* {
      return t < n ? words_of(src, static_cast<size_t>(tok0 + t) * C) : nullptr;
    }, p.x);
  };
  rows_in(Rb, p.x);
  rows_in(Zb, p.dz);
  // while they are in flight: this lane's LayerNorm parameters (features
  // lane + 32 i) and each token's DropPath scale
  constexpr int kI = kMaxC / 32;
  float lw[kI], lb[kI];
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    const int c = lane + 32 * i;
    lw[i] = c < C ? p.ln_w[c] : 0.f;
    lb[i] = c < C ? p.ln_b[c] : 0.f;
  }
  if (threadIdx.x < kTok)
    scale[threadIdx.x] = p.mode == kScaled && threadIdx.x < n
                             ? p.s[(tok0 + threadIdx.x) / p.tokens_per_sample]
                             : 1.f;
  cp_async_wait<1>();   // x's rows; dz's land during fc1
  __syncthreads();
  layer_norm_rows<T>(Rb, ldR, n, C, lw, lb);   // LN(x) in place of x, rounded

  // h = LN(x) W1[chunk]^T + b1, kept in registers; g = GELU(h) into H. A
  // warp owns tokens m0 .. m0 + 15 and the n8 tiles wn + 4 jj in this and dh.
  float h[3][4] = {};
  streamed_product<R, T, 3, false>(h, Cw, kKq, hcp, kKq + 4, stages, L.stage_words, fc1_in,
                                   [&](uint32_t (&a)[4], int m, int k) {
                                     frag_a(a, Rb, ldR, m, k);
                                   });
  prefetch(dh_in);
  if (p.mode == kScaled)   // s dz in place of dz, rounded
    for (int t = warp; t < n; t += kWarps) {
      const float s = scale[t];
#pragma unroll
      for (int i = 0; i < kI; ++i) {
        const int c = lane + 32 * i;
        if (c < C) set1<T>(Zb, ldR, t, c, round_to<T>(s * get1<T>(Zb, ldR, t, c)));
      }
    }
#pragma unroll
  for (int jj = 0; jj < 3; ++jj) {
    const int o0 = 8 * (wn + 4 * jj), j = o0 + 2 * tq;
    if (o0 >= hcp) break;
    const bool col = j < hc;   // hc % 4 == 0: j + 1 < hc too
    const float b0 = col ? p.b1[j0 + j] : 0.f, b1 = col ? p.b1[j0 + j + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + g + 8 * i;
      h[jj][2 * i] += b0;
      h[jj][2 * i + 1] += b1;
      const bool ok = col && m < n;   // zero in the padded columns and tokens
      set2<T>(Hb, ldH, m, j, ok ? round_to<T>(gelu(h[jj][2 * i])) : 0.f,
              ok ? round_to<T>(gelu(h[jj][2 * i + 1])) : 0.f);
    }
  }
  __syncthreads();
  // dW2[c][j0 + j] += sum_t s dz[t][c] g[t][j]
  smem_product<R, 3>(
      C, hcp, Kp, [&](uint32_t (&a)[4], int m, int k) { frag_a_t<T>(a, Zb, ldR, m, k); },
      [&](uint32_t (&b)[2], int n0, int k) { frag_b_t<T>(b, Hb, ldH, n0, k); },
      [&](int mt, int nt, const float (&c)[4]) {
        red_tile4(c, mt, nt, [&](int row, int j) -> float* {
          return row < C && j < hc ? p.dw2 + static_cast<size_t>(row) * hidden + j0 + j
                                   : nullptr;
        });
      });
  {  // dh = s dz W2[:, chunk]; dh' = dh GELU'(h) into H, rounded; d b1 = the
     // column sums of dh' (a warp's 16 rows by shuffles, its 4 token warps in red)
    float dh[3][4] = {};
    streamed_product<R, T, 3, true>(dh, Cw, kKq, hcp, ldH, stages, L.stage_words, dh_in,
                                    [&](uint32_t (&a)[4], int m, int k) {
                                      frag_a(a, Zb, ldR, m, k);
                                    });
    prefetch(dln_in);
#pragma unroll
    for (int jj = 0; jj < 3; ++jj) {
      const int o0 = 8 * (wn + 4 * jj), j = o0 + 2 * tq;
      if (o0 >= hcp) break;
      float c0 = 0.f, c1 = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = m0 + g + 8 * i;
        const bool ok = j < hc && m < n;
        const float d0 = ok ? dh[jj][2 * i] * gelu_grad(h[jj][2 * i]) : 0.f;
        const float d1 = ok ? dh[jj][2 * i + 1] * gelu_grad(h[jj][2 * i + 1]) : 0.f;
        set2<T>(Hb, ldH, m, j, round_to<T>(d0), round_to<T>(d1));
        c0 += d0;
        c1 += d1;
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        c0 += __shfl_xor_sync(0xffffffffu, c0, o);
        c1 += __shfl_xor_sync(0xffffffffu, c1, o);
      }
      if (g == 0) {
        red[(warp & 3) * kChunk + j] = c0;
        red[(warp & 3) * kChunk + j + 1] = c1;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < hc)
    atomicAdd(p.db1 + j0 + threadIdx.x, red[threadIdx.x] + red[kChunk + threadIdx.x] +
                                            red[2 * kChunk + threadIdx.x] +
                                            red[3 * kChunk + threadIdx.x]);
  // dW1[j0 + j][c] += sum_t dh'[t][j] LN(x)[t][c]
  smem_product<R, 3>(
      hcp, C, Kp, [&](uint32_t (&a)[4], int m, int k) { frag_a_t<T>(a, Hb, ldH, m, k); },
      [&](uint32_t (&b)[2], int n0, int k) { frag_b_t<T>(b, Rb, ldR, n0, k); },
      [&](int mt, int nt, const float (&c)[4]) {
        red_tile4(c, mt, nt, [&](int j, int col) -> float* {
          return j < hc && col < C ? p.dw1 + static_cast<size_t>(j0 + j) * C + col : nullptr;
        });
      });
  // dL/dLN(x) += dh' W1[chunk], into the (tokens, C) buffer
  float acc[kMaxC / 32][4] = {};
  streamed_product<R, T, kMaxC / 32, true>(acc, Hw, kKw, C, ldR, stages, L.stage_words, dln_in,
                                           [&](uint32_t (&a)[4], int m, int k) {
                                             frag_a(a, Hb, ldH, m, k);
                                           });
#pragma unroll
  for (int jj = 0; jj < kMaxC / 32; ++jj) {
    const int c0 = 8 * (wn + 4 * jj);
    if (c0 >= C) break;
    red_tile4(acc[jj], m0, c0, [&](int t, int c) {
      return t < n && c < C ? p.dln + static_cast<size_t>(tok0 + t) * C + c : nullptr;
    });
  }
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = mlp_smem_bytes(sizeof(T) == 4 ? 0 : 1, p.channels);
  cudaError_t err = cudaFuncSetAttribute(mlp_block_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (p.tokens + kTok - 1) / kTok, chunks = (p.hidden + kChunk - 1) / kChunk;
  mlp_block_bwd_kernel<T><<<tiles * chunks, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const LnBackwardParams ln{p.x, p.dz, p.dx, p.dln, p.tokens, p.channels, p.tokens_per_sample,
                            p.mode, p.ln_w, p.s, p.dln_w, p.dln_b, p.db2};
  return launch_ln_backward<T>(ln, stream);
}

}  // namespace

extern "C" {

// Shared memory one thread block of the (tile, chunk) kernel takes, in
// bytes; dtype 0 float32, 1 bfloat16.
size_t mlp_block_bwd_smem_bytes(int dtype, int channels) {
  return mlp_smem_bytes(dtype, channels);
}

// Number of floats in the gradient buffer: d ln_w (C), d ln_b (C),
// d W1 (hidden * C), d b1 (hidden), d W2 (C * hidden), d b2 (C), in this order.
size_t mlp_block_bwd_grad_floats(int channels, int hidden) {
  return 3 * static_cast<size_t>(channels) + hidden + 2 * static_cast<size_t>(channels) * hidden;
}

// dtype: 0 float32, 1 bfloat16; mode: 0 branch, 1 branch + x, 2 s * branch + x.
// scratch: tokens * channels floats. Zeroes `grads` and `scratch` on the
// stream, then launches the two kernels. Returns the cudaError_t (0 on
// success); cudaErrorInvalidValue for C > 256.
int mlp_block_bwd(int dtype, const void* x, const void* dz, void* dx, int tokens, int channels,
                  int hidden, int tokens_per_sample, const float* ln_w, const float* ln_b,
                  const void* w1, const float* b1, const void* w2, int mode, const float* s,
                  float* grads, float* scratch, void* stream) {
  if (channels > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t C = channels, H = hidden;
  cudaError_t err =
      cudaMemsetAsync(grads, 0, mlp_block_bwd_grad_floats(channels, hidden) * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(scratch, 0, static_cast<size_t>(tokens) * C * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* dln_w = grads;
  float* dln_b = dln_w + C;
  float* dw1 = dln_b + C;
  float* db1 = dw1 + H * C;
  float* dw2 = db1 + H;
  float* db2 = dw2 + C * H;
  const Params p{x,  dz, dx,   tokens, channels, hidden, tokens_per_sample, ln_w, ln_b, w1, b1,
                 w2, mode, s,  dln_w,  dln_b,    dw1,    db1,               dw2,  db2,  scratch};
  if (dtype == 0) return launch<float>(p, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mlp_block_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
