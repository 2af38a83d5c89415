// The whole Swin transformer block, forward, one thread block per window,
// every product on the tensor cores: the body shared by
// swin_block_joint_fwd.cu (float32 / bfloat16) and
// swin_block_joint_int8_fwd.cu (the four weight products in int8).
//
// For x (B, H, W, C), already rolled by the caller,
//
//   y   = x + s1 * proj(W-MSA(LN1(x)))     // relative-position bias (+ shift mask)
//   out = y + s2 * fc2(GELU(fc1(LN2(y))))
//
// with LN statistics, softmax and every accumulation of a float product in
// float32, the qk scale applied to q in float32 and exact (erf) GELU. s1,
// s2 are DropPath's per-sample scales (1 when the pointers are null).
//
// kInt8 = false: every product input is rounded to the model dtype T (LN's
// output, q (after the scale), k, v, P, the attention output, GELU's output).
// kInt8 = true: qkv, proj, fc1 and fc2 are int8 x int8 -> int32. Weights come
// quantised per output channel (int8 rows padded with zeros to a multiple of
// 16, float32 scales). The activation entering each of them (LN1's output,
// the attention output, LN2's output, GELU's output) is quantised in float32
// with one dynamic scale for the window (LN's and GELU's outputs unrounded,
// the attention output rounded to T), and the sum is dequantised as
// acc * (s_x * s_w[col]) + bias in float32. q.k, p.v, softmax, LayerNorm,
// GELU and the residuals are as in the float kernel.
//
// Products (tensor_core.cuh): M is always the window's 64 tokens (4 m16
// tiles), and 16 warps split them as 4 along M by 4 along N. float32 is
// 3xTF32 on m16n8k8 (plain TF32's 2^-11 would leave the float32 tolerance),
// bfloat16 m16n8k16, int8 m16n8k32 with exact int32 sums. Every operand is
// a matrix of 32-bit words (one float, two bfloat16 or four int8 of
// consecutive k) and the three products read them in the same pattern, so
// one code path serves all three:
// - activations sit feature-major, one row of kLdA words per word of
//   features (kLdA = 8 mod 32: a fragment's 32 loads hit 32 banks); the
//   int8 kernel's quantised rows pack four features of a token in a word,
//   which is the s8 A fragment as it stands;
// - weight rows keep the nn.Linear (out, in) layout and stream from L2
//   through two shared-memory stages by cp.async (a whole C-deep product a
//   stage in bfloat16 and int8, 32 words of K in float32 for want of room),
//   the first stage of each product issued ahead of the work before it,
//   zero-filled past K to the k-step (so the int8 rows' padding to 16 is
//   enough). float32 operands are split into hi and lo as a warp loads
//   them: a pass over each stage (split once into hi and lo planes, as K10
//   does) and its extra barrier took a fifth of the window's time;
// - qkv runs per head (N = 3 x head dim padded to 16 with zero rows: 96 at
//   head dim 30); q.k (K = the padded head dim) and the softmax take a
//   warp's 16 queries by 16 keys, with the row max and sum across the four
//   warps of a query tile in shared memory; p.v gives each warp 16 queries
//   by 8 head features;
// - p.v writes every head's output into the AO rows, and proj runs once
//   over them (one product of C-deep rows streams better than six of a head
//   each); its accumulators stay in registers, and so do fc2's across the
//   hidden chunks of 96: 6 n8 tiles a warp, so C <= 192. y = x + s1 (proj +
//   b) stays in those registers; LN2 reduces it across warps through shared
//   memory, and the output leaves from registers. The int8 kernel quantises
//   the attention output of all heads with one scale, over LN1's dead rows;
//   all hidden rows of its GELU output stay in shared memory for fc2's
//   absmax;
// - LN1 takes a warp a token, its statistics by shuffles; the bias (+ mask)
//   of a head is loaded as the head starts, so that the loads overlap qkv.
// Head dim <= 32; a window of n < 64 tokens (ws < 8) pads its tile with
// zero tokens, and its keys past n drop out of the softmax. Past C = 192 or
// heads of 32 the int8 kernel runs its wide variant (Dims<true>, below; C
// <= 256, heads of up to 64): the same integers, by the same rounding.
//
// What holds it back (clock64 of every warp of one block, on an NVIDIA H100
// 80GB HBM3 at 700 W, B=1 128x128 SwinIR-M): the warps are in step (each
// barrier's slowest warp within 5% of the mean), and the weight stream sets
// the pace. A window copies 1.04 MB of float32 weights (0.52 MB bfloat16,
// 0.26 MB int8) from L2 by cp.async, 16 or 8 bytes a thread at a time: the
// copies' issue and wait take about as long as the products in bfloat16 and
// int8, and all 132 SMs read the same rows. In float32 the 3xTF32 products
// are half the time (three mma and four conversions a tile). TMA bulk
// copies, one a row issued by one warp with an mbarrier a stage, took twice
// as long as cp.async; what is left to try is a 2-D TMA tile a stage,
// multicast across a cluster of SMs that share the weights.

#pragma once

#include <type_traits>

#include "swin_common.cuh"
#include "tensor_core.cuh"

namespace swin {

constexpr int kLdA = 72;      // words a feature-major activation row: 64 tokens + 8
constexpr int kLdV = 40;      // words a row of v: 32 head features + 8
constexpr int kMaxN = 192;    // outputs of one weight product: 4 warps x 6 n8 tiles
constexpr int kHid = 96;      // MLP hidden columns a chunk: 4 warps x 3 n8 tiles
constexpr int kMaxHeadDim = 32;
constexpr int kRed = 2 * 4 * kTok;   // floats of cross-warp partial sums

// The int8 kernel's wide variant (kWide), for blocks past those widths:
// SwinIR-L's C = 240 in heads of 30, heads of 60 (C = 180 in 3). C <= 256
// (8 n8 tiles a warp), heads padded to 64 features (qkv 6 n8 tiles a warp,
// p.v 2), v's rows of kLdV + 32 words, P over q and k's rows, weight stages
// of 256 rows by 32 words, and fc1 run twice over the hidden chunks: once
// for fc2's absmax over the whole window, once to quantise each chunk for
// fc2, whose int32 sums add up over the chunks. So GELU's output is never
// held whole (480 float rows at C = 240 took 138 KB).
constexpr int kWideMaxN = 256;
constexpr int kWideMaxHeadDim = 64;

template <bool kWide>
struct Dims {
  static constexpr int kNc = kWide ? 8 : 6;           // n8 tiles a warp of a C-wide output
  static constexpr int kNq = kWide ? 6 : 3;           // of q | k | v of a head
  static constexpr int kPv = kWide ? 2 : 1;           // of a head's output
  static constexpr int kRows = kWide ? kWideMaxN : kMaxN;   // rows a weight stage holds
  static constexpr int kLdVw = kWide ? kLdV + 32 : kLdV;    // words a row of v
};

// The widths each kernel takes (K1 and the int8 kernel; the int8 kernel's
// wide variant past them).
__host__ __device__ inline bool joint_takes(int channels, int heads) {
  return channels <= kMaxN && channels / heads <= kMaxHeadDim;
}
__host__ __device__ inline bool wide_takes(int channels, int heads) {
  return channels <= kWideMaxN && channels / heads <= kWideMaxHeadDim;
}

enum Route { kTF32x3, kBF16, kS8 };
template <Route R>
using Acc = typename std::conditional<R == kS8, int, float>::type;

__host__ __device__ inline int round_up16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Word offsets of the buffers. P: features of the model dtype a word (1
// float32, 2 bfloat16). XN at 0: C / P rows (the int8 kernel: C float rows,
// which hold LN1's output, the attention output and LN2's output in turn,
// and with the rows after them all hidden rows of GELU's output).
struct Layout {
  int ao;      // float kernel: the attention output, C / P rows
  int attn;    // q, k (padded head dim / P rows each), v, P; the float kernel's GELU chunk
  int q8;      // int8 kernel: quantised activation, round_up16(max(C, hidden)) / 4 rows
  int stages;  // two weight stages
  int red;
  int words;
};

// Words of K a weight stage holds: a whole C-deep product in bfloat16 (C <=
// 192) and in int8, where shared memory allows it; 32 in float32 and in the
// wide variant. A staged row takes 4 words more (= 4 mod 8: a fragment's
// loads hit 32 banks).
__host__ __device__ constexpr int stage_words(bool int8, int P, bool wide = false) {
  return wide ? 32 : int8 ? 48 : P == 2 ? 96 : 32;
}

// wide: the int8 kernel's wide variant, whose P shares q and k's rows and
// whose quantised activations are C-wide (GELU's a chunk at a time, over XN)
__host__ __device__ inline Layout joint_layout(int channels, int heads, int hidden, bool int8,
                                               int P, bool wide = false) {
  const int hdw = round_up16(channels / heads) / P;
  const int attn = wide ? imax(2 * hdw, kTok / P) * kLdA + kTok / P * (kLdV + 32)
                        : 2 * hdw * kLdA + kTok / P * kLdV + kTok / P * kLdA;
  Layout l;
  l.ao = (int8 ? channels : channels / P) * kLdA;
  l.attn = l.ao + (int8 ? 0 : channels / P * kLdA);
  int region = l.attn + imax(attn, int8 ? 0 : kHid / P * kLdA);
  if (int8 && !wide) region = imax(region, hidden * kLdA);
  l.q8 = region;
  l.stages = l.q8 + (int8 ? round_up16(wide ? channels : imax(channels, hidden)) / 4 * kLdA : 0);
  l.red = l.stages + 2 * (wide ? kWideMaxN : kMaxN) * (stage_words(int8, P, wide) + 4);
  l.words = l.red + kRed;
  return l;
}

// Dynamic shared memory of a block; dtype 0 float32, 1 bfloat16. The int8
// kernel past joint_takes' widths runs its wide variant.
inline size_t joint_smem_bytes(int dtype, int channels, int heads, int hidden, bool int8) {
  const bool wide = int8 && !joint_takes(channels, heads);
  return static_cast<size_t>(
             joint_layout(channels, heads, hidden, int8, dtype + 1, wide).words) * 4;
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

// ------------------------------------------------------------ word buffers
// Feature c of token t in a feature-major buffer of S (float or bfloat16).
template <typename S>
__device__ __forceinline__ void put1(uint32_t* X, int c, int t, float v) {
  if constexpr (sizeof(S) == 4)
    X[c * kLdA + t] = __float_as_uint(v);
  else
    reinterpret_cast<__nv_bfloat16*>(X)[(c / 2 * kLdA + t) * 2 + (c & 1)] = __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// features c and c + 1 (c even) of token t
template <typename S>
__device__ __forceinline__ void put2(uint32_t* X, int c, int t, float v0, float v1) {
  if constexpr (sizeof(S) == 4) {
    X[c * kLdA + t] = __float_as_uint(v0);
    X[(c + 1) * kLdA + t] = __float_as_uint(v1);
  } else {
    X[c / 2 * kLdA + t] = pack_bf16(v0, v1);
  }
}

// v[key][d], v[key][d + 1] (d even): one row of kLd words per word of keys
template <typename T, int kLd = kLdV>
__device__ __forceinline__ void put_v(uint32_t* V, int key, int d, float v0, float v1) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float2*>(V + key * kLd + d) = make_float2(v0, v1);
  } else {
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(V) + (key / 2 * kLd + d) * 2 + (key & 1);
    e[0] = __float2bfloat16(v0);
    e[2] = __float2bfloat16(v1);
  }
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// acc * d, kept a multiplication of its own (no fused multiply-add with the
// bias that follows), as the plain version computes it.
__device__ __forceinline__ float dequant(int acc, float d) {
  return __fmul_rn(static_cast<float>(acc), d);
}

// cp.async of kWords words, zero-filled where ok is false (nothing is read then)
template <int kWords>
__device__ __forceinline__ void cp_async_zfill(uint32_t* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 4 * kWords : 0;
  if constexpr (kWords == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(4 * kWords), "r"(n)
                 : "memory");
}

// ---------------------------------------------------------------- products
// This lane's A fragment of rows m0..m0+15 at words kw0..kw0+7 of the
// feature-major A (zero at words >= Kw); for TF32 also split into hi / lo.
template <Route R>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], uint32_t (&al)[4], const uint32_t* A,
                                       int m0, int kw0, int Kw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kw = kw0 + t + 4 * (r >> 1);
    a[r] = kw < Kw ? A[kw * kLdA + m0 + g + 8 * (r & 1)] : 0u;
    if constexpr (R == kTF32x3) tc::split_tf32(a[r], a[r], al[r]);
  }
}

// c += a . b on one 16 x 8 tile and one k-step, one product
template <Route R>
__device__ __forceinline__ void mma_one(Acc<R> (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  if constexpr (R == kTF32x3)
    tc::mma_tf32(c, a, b0, b1);
  else if constexpr (R == kBF16)
    tc::mma_bf16(c, a, b0, b1);
  else
    tc::mma_s8(c, a, b0, b1);
}

// c += a . b with B's words as they are in shared memory (TF32: split here,
// then the three products, the small ones first)
template <Route R>
__device__ __forceinline__ void mma_tile_raw(Acc<R> (&c)[4], const uint32_t (&a)[4],
                                             const uint32_t (&al)[4], uint32_t b0, uint32_t b1) {
  if constexpr (R == kTF32x3) {
    uint32_t bl0, bl1;
    tc::split_tf32(b0, b0, bl0);
    tc::split_tf32(b1, b1, bl1);
    mma_one<R>(c, al, b0, b1);
    mma_one<R>(c, a, bl0, bl1);
  }
  mma_one<R>(c, a, b0, b1);
}

// The weight rows of one product: row(o), the Kw words of row o < N in
// device memory, aligned to kCopy words (nullptr: a row of zeros). They
// stream from L2 through two shared-memory stages of kK words of K (rows
// of kK + 4 words) by cp.async, zero-filled past Kw to the k-step; `any` is
// some device address for the zero-filled copies, which read nothing.
// prefetch() issues the first stage (one commit group) as soon as the
// stages are free: the load then overlaps whatever the block does before
// the product runs, which issues no other cp.async.
template <int kK, int kCopy, class Row, int kRows = kMaxN>
struct WeightStream {
  static constexpr int kLd = kK + 4;
  int Kw, N, steps;
  Row row;
  uint32_t* stages;
  const void* any;

  __device__ WeightStream(int kw, int n, Row r, uint32_t* st, const void* a)
      : Kw(kw), N(n), steps((kw + kK - 1) / kK), row(r), stages(st), any(a) {}

  __device__ __forceinline__ uint32_t* stage(int step) const {
    return stages + (step & 1) * kRows * kLd;
  }

  __device__ __forceinline__ void stage_in(int step) const {   // empty past the last step
    constexpr int kPerRow = kK / kCopy;
    if (step < steps) {
      uint32_t* st = stage(step);
      const int kw0 = step * kK, kwn = min(kK, Kw - kw0), kwp = (kwn + 7) & ~7;
      for (int c = threadIdx.x; c < N * kPerRow; c += kThreads) {
        const int o = c / kPerRow, q = (c - o * kPerRow) * kCopy;
        if (q >= kwp) continue;
        const uint32_t* src = row(o);
        const bool ok = src != nullptr && q < kwn;
        cp_async_zfill<kCopy>(st + o * kLd + q,
                              ok ? static_cast<const void*>(src + kw0 + q) : any, ok);
      }
    }
    cp_async_commit();
  }

  __device__ __forceinline__ void prefetch() const { stage_in(0); }

};

template <int kK, int kCopy, int kRows = kMaxN, class Row>
__device__ __forceinline__ WeightStream<kK, kCopy, Row, kRows> weights(int Kw, int N, Row row,
                                                                      uint32_t* stages,
                                                                      const void* any) {
  return WeightStream<kK, kCopy, Row, kRows>(Kw, N, row, stages, any);
}

// acc[jj] += A . W^T for this warp's 16 tokens (rows 16 (warp % 4) ...) and
// its n8 tiles j = warp / 4 + 4 jj, with A feature-major words and W the
// rows of w, whose prefetch() has been issued. TF32 splits the weights as it
// reads them: a pass over each stage and a barrier cost more than the
// conversions. Begins with the block in step on A and ends with every warp
// done with A and the stages.
template <Route R, int NT, int kK, int kCopy, class Row, int kRows>
__device__ __forceinline__ void weight_product(Acc<R> (&acc)[NT][4], const uint32_t* A,
                                               const WeightStream<kK, kCopy, Row, kRows>& w) {
  constexpr int kLd = WeightStream<kK, kCopy, Row, kRows>::kLd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, m0 = (warp & 3) * 16, ni = warp >> 2;
  for (int step = 0; step < w.steps; ++step) {
    cp_async_wait<0>();
    __syncthreads();   // this step's stage has landed for every thread, the other is free
    w.stage_in(step + 1);
    const uint32_t* st = w.stage(step);
    const int kw0 = step * kK, kwp = (min(kK, w.Kw - kw0) + 7) & ~7;
    // every tile a warp owns, those past N too (their sums are never read):
    // the products of a k-step are independent, so none waits on another
#pragma unroll 4
    for (int ks = 0; ks < kK; ks += 8) {
      if (ks >= kwp) break;
      uint32_t a[4], al[4], b[NT][2], bl[NT][2];
      load_a<R>(a, al, A, m0, kw0 + ks, w.Kw);
#pragma unroll
      for (int jj = 0; jj < NT; ++jj) {
        const int at = (8 * (ni + 4 * jj) + g) * kLd + ks + t;
        b[jj][0] = st[at];
        b[jj][1] = st[at + 4];
        if constexpr (R == kTF32x3) {
          tc::split_tf32(b[jj][0], b[jj][0], bl[jj][0]);
          tc::split_tf32(b[jj][1], b[jj][1], bl[jj][1]);
        }
      }
      if constexpr (R == kTF32x3) {   // term by term, the small products first
#pragma unroll
        for (int jj = 0; jj < NT; ++jj) mma_one<R>(acc[jj], al, b[jj][0], b[jj][1]);
#pragma unroll
        for (int jj = 0; jj < NT; ++jj) mma_one<R>(acc[jj], a, bl[jj][0], bl[jj][1]);
      }
#pragma unroll
      for (int jj = 0; jj < NT; ++jj) mma_one<R>(acc[jj], a, b[jj][0], b[jj][1]);
    }
  }
  __syncthreads();
}

// f(token, o, v_o, v_o+1) over this warp's accumulators with o < N (o even)
template <int NT, class V, class F>
__device__ __forceinline__ void for_each_pair(const V (&acc)[NT][4], int N, F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = (warp & 3) * 16 + (lane >> 2), ni = warp >> 2;
#pragma unroll
  for (int jj = 0; jj < NT; ++jj) {
    const int o = 8 * (ni + 4 * jj) + 2 * (lane & 3);
    if (o < N) {
      f(m, o, acc[jj][0], acc[jj][1]);
      f(m + 8, o, acc[jj][2], acc[jj][3]);
    }
  }
}

// ------------------------------------------------------ per-token reductions
// The window's scale max(absmax, 1e-12) / 127 from each thread's share m of
// the absmax, to every thread; red: kWarps floats of scratch, free for
// writes after the block's next barrier.
__device__ __forceinline__ float window_scale(float m, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) m = fmaxf(m, red[i]);
  return fmaxf(m, 1e-12f) * (1.f / 127.f);
}

// v's integer at scale 1 / inv: rint (half to even), clipped to +-127
__device__ __forceinline__ int quantize(float v, float inv) {
  return static_cast<int>(fminf(fmaxf(rintf(v * inv), -127.f), 127.f));
}

// Symmetric int8 quantisation of the `rows` float features of the window's
// n tokens in the feature-major A, with one dynamic scale for the window:
// s = max(absmax, 1e-12) / 127, q = clip(rint(v * (1 / s)), -127, 127)
// (rint rounds half to even). Q receives rows_p / 4 rows of packed words
// (rows_p % 16 == 0), zero for features >= rows and tokens >= n. red:
// kWarps floats of scratch. Returns s to every thread; ends with the block
// in step.
__device__ inline float quantize_window(const uint32_t* A, int rows, int rows_p, int n,
                                        uint32_t* Q, float* red) {
  float m = 0.f;
  for (int e = threadIdx.x; e < rows * kTok; e += kThreads) {
    const int t = e % kTok;
    if (t < n) m = fmaxf(m, fabsf(__uint_as_float(A[(e / kTok) * kLdA + t])));
  }
  const float s = window_scale(m, red);
  const float inv = 1.f / s;
  for (int e = threadIdx.x; e < (rows_p / 4) * kTok; e += kThreads) {
    const int w = e / kTok, t = e % kTok;
    unsigned word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * w + i;
      const float v = r < rows && t < n ? __uint_as_float(A[r * kLdA + t]) : 0.f;
      word |= static_cast<unsigned>(quantize(v, inv) & 0xff) << (8 * i);
    }
    Q[w * kLdA + t] = word;
  }
  __syncthreads();
  return s;
}

// For the two rows (tokens m, m + 8) this lane holds of the y accumulators:
// mean and 1 / std over the C features, summed across the four warps of a
// token tile through red (2 * 4 * kTok floats). Ends with the block in step.
template <int NT>
__device__ __forceinline__ void row_stats(const float (&y)[NT][4], int C, float* red,
                                          float (&mu)[2], float (&inv)[2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = (warp & 3) * 16 + (lane >> 2), ni = warp >> 2;
  float s[2] = {0.f, 0.f}, ss[2] = {0.f, 0.f};
#pragma unroll
  for (int jj = 0; jj < NT; ++jj) {
    if (8 * (ni + 4 * jj) + 2 * (lane & 3) >= C) continue;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      s[r >> 1] += y[jj][r];
      ss[r >> 1] += y[jj][r] * y[jj][r];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      s[h] += __shfl_xor_sync(0xffffffffu, s[h], o);
      ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], o);
    }
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      red[ni * kTok + m + 8 * h] = s[h];
      red[(4 + ni) * kTok + m + 8 * h] = ss[h];
    }
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a += red[i * kTok + m + 8 * h];
      b += red[(4 + i) * kTok + m + 8 * h];
    }
    mu[h] = a / C;
    inv[h] = rsqrtf(b / C - mu[h] * mu[h] + 1e-5f);
  }
}

// ------------------------------------------------------------------ the block
template <typename T, bool kInt8, bool kWide = false>
__global__ void __launch_bounds__(kThreads, 1) swin_block_joint_kernel(const JointParams p) {
  static_assert(kInt8 || !kWide, "the wide variant is the int8 kernel's");
  using D = Dims<kWide>;
  constexpr Route kAttn = sizeof(T) == 4 ? kTF32x3 : kBF16;   // q.k, p.v
  constexpr Route kW = kInt8 ? kS8 : kAttn;                    // qkv, proj, fc1, fc2
  constexpr int P = 4 / sizeof(T);                             // features of T a word
  using S = typename std::conditional<kInt8, float, T>::type;  // what XN holds
  using AccW = Acc<kW>;
  // rows of T in device memory: 16-byte copies for float32, 8 for bfloat16
  // (int8 rows are padded to 16 bytes)
  constexpr int kCopyRows = kInt8 || P == 1 ? 4 : 2;
  constexpr int kK = stage_words(kInt8, P, kWide);
  extern __shared__ __align__(16) uint32_t smem[];

  const int H = p.height, W = p.width, C = p.channels, heads = p.heads, hidden = p.hidden;
  const int ws = p.window, n = ws * ws, hd = C / heads, hdp = round_up16(hd);
  const float scale = p.scale;
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  const float *bqkv = p.bqkv, *bproj = p.bproj, *b1 = p.b1, *b2 = p.b2;

  const int nww = W / ws, nw = (H / ws) * nww;
  const int img = blockIdx.x / nw, win = blockIdx.x % nw;
  const int row0 = (win / nww) * ws, col0 = (win % nww) * ws;
  const float* mask = p.mask ? p.mask + static_cast<size_t>(win) * n * n : nullptr;
  const float s1 = p.s1 ? p.s1[img] : 1.f, s2 = p.s2 ? p.s2[img] : 1.f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3, m0 = (warp & 3) * 16, ni = warp >> 2;

  const Layout L = joint_layout(C, heads, hidden, kInt8, P, kWide);
  const int hdw = hdp / P;
  uint32_t* XN = smem;                  // LN1(x); attention output (int8); LN2(y); GELU (int8)
  uint32_t* AO = kInt8 ? XN : smem + L.ao;   // the attention output of every head
  uint32_t* Qh = smem + L.attn;         // q (scaled) of one head, feature-major
  uint32_t* Kh = Qh + hdw * kLdA;       // k, feature-major
  // v, a row a word of keys; the probabilities, feature-major over keys
  // (the wide variant's over q and k, which are read by then)
  uint32_t* Vh = kWide ? Qh + imax(2 * hdw, kTok / P) * kLdA : Kh + hdw * kLdA;
  uint32_t* Pm = kWide ? Qh : Vh + kTok / P * kLdV;
  uint32_t* HB = smem + L.attn;         // a chunk of GELU(fc1) (float kernel)
  uint32_t* Q8 = smem + L.q8;           // a quantised activation (int8 kernel)
  uint32_t* stages = smem + L.stages;
  float* red = reinterpret_cast<float*>(smem + L.red);
  const int Cp = round_up16(C), Hp = round_up16(hidden);

  // token t of the window sits at row row0 + t / ws, column col0 + t % ws
  auto offset = [&](int t) {
    return ((static_cast<size_t>(img) * H + row0 + t / ws) * W + col0 + t % ws) * C;
  };
  // product `stage` (0 qkv, 1 proj, 2 fc1, 3 fc2) read the `rows` features
  // at scale s; Q holds features r0 .. r0 + rn - 1 of them
  auto keep_quantised = [&](int stage, int rows, float s, const uint32_t* Q, int r0, int rn) {
    if (p.quant_q == nullptr) return;
    int8_t* dst = p.quant_q + static_cast<size_t>(stage) * p.batch * H * W * C;
    for (int e = threadIdx.x; e < n * rn; e += kThreads) {
      const int t = e / rn, r = e % rn;
      const uint32_t word = Q[(r >> 2) * kLdA + t];
      dst[offset(t) / C * rows + r0 + r] = static_cast<int8_t>((word >> (8 * (r & 3))) & 0xff);
    }
    if (threadIdx.x == 0) p.quant_s[stage * gridDim.x + blockIdx.x] = s;
  };
  // a weight row's first word: T rows of `ld` elements, or int8 rows of `ld` bytes
  auto wrow = [&](const void* w, size_t element, int ld) {
    const size_t at = element * static_cast<size_t>(ld);
    return kInt8 ? reinterpret_cast<const uint32_t*>(static_cast<const int8_t*>(w) + at)
                 : reinterpret_cast<const uint32_t*>(static_cast<const T*>(w) + at);
  };

  // The weight rows of the products. Each is prefetched as soon as the
  // stages are free, ahead of the work that precedes it: qkv of head 0
  // before LN1, qkv of the next head (proj after the last) before the
  // attention of this one, fc1 before LN2, fc2 before GELU.
  const int Kc = kInt8 ? Cp / 4 : C / P;   // words of a C-deep product input
  auto qkv_part = [&](int o, int& part) {   // output o: part o / hdp, head feature o % hdp
    part = o >= 2 * hdp ? 2 : o >= hdp ? 1 : 0;
    return o - part * hdp;
  };
  auto qkv_rows = [&](int h) {
    return weights<kK, kCopyRows, D::kRows>(Kc, 3 * hdp, [&, h](int o) -> const uint32_t* {
      int part;
      const int d = qkv_part(o, part);
      return d < hd ? wrow(p.wqkv, part * C + h * hd + d, kInt8 ? Cp : C) : nullptr;
    }, stages, p.x);
  };
  const auto proj_rows = weights<kK, kCopyRows, D::kRows>(
      Kc, C, [&](int o) { return wrow(p.wproj, o, kInt8 ? Cp : C); }, stages, p.x);
  auto fc1_rows = [&](int j0) {
    return weights<kK, kCopyRows, D::kRows>(Kc, min(kHid, hidden - j0), [&, j0](int o) {
      return wrow(p.w1, j0 + o, kInt8 ? Cp : C);
    }, stages, p.x);
  };
  qkv_rows(0).prefetch();

  // LN1(x) into XN, a warp a token, the loads of its four tokens issued
  // together (tokens past n are zero)
  {
    constexpr int kPer = kTok / kWarps, kCols = D::kNc;   // C / 32 a lane
    float v[kPer][kCols];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int t = warp + kWarps * k;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int c = lane + 32 * i;
        v[k][i] = t < n && c < C ? to_f32(x[offset(t) + c]) : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        s += v[k][i];
        ss += v[k][i] * v[k][i];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
      }
      const float mu = s / C, inv = rsqrtf(ss / C - mu * mu + 1e-5f);
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int c = lane + 32 * i;
        if (c < C)
          put1<S>(XN, c, warp + kWarps * k,
                  round_to<S>((v[k][i] - mu) * inv * p.ln1_w[c] + p.ln1_b[c]));
      }
    }
  }
  __syncthreads();
  float sx = 0.f;
  if constexpr (kInt8) {
    sx = quantize_window(XN, C, Cp, n, Q8, red);
    keep_quantised(0, C, sx, Q8, 0, C);
  }

  for (int h = 0; h < heads; ++h) {
    // this warp's scores start as bias (+ mask), loaded here so that the
    // loads overlap the qkv product; keys >= n drop out
    const float* bias = p.rel_bias + static_cast<size_t>(h) * n * n;
    float sc[2][4];
#pragma unroll
    for (int jt = 0; jt < 2; ++jt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int q = m0 + g + 8 * (r >> 1), key = 16 * ni + 8 * jt + 2 * tq + (r & 1);
        sc[jt][r] = key >= n ? -INFINITY
                    : q < n  ? bias[q * n + key] + (mask ? mask[q * n + key] : 0.f)
                             : 0.f;
      }
    {  // q (scaled), k, v of head h
      AccW acc[D::kNq][4] = {};
      weight_product<kW>(acc, kInt8 ? Q8 : XN, qkv_rows(h));
      if (h + 1 < heads)
        qkv_rows(h + 1).prefetch();
      else
        proj_rows.prefetch();
      for_each_pair<D::kNq>(acc, 3 * hdp, [&](int m, int o, AccW v0, AccW v1) {
        int part;
        const int d = qkv_part(o, part);
        float f0 = 0.f, f1 = 0.f;   // zero in the padded head features
        if (d < hd) {
          const int r = part * C + h * hd + d;
          if constexpr (kInt8) {
            f0 = round_to<T>(dequant(v0, sx * p.sqkv[r]) + bqkv[r]);
            f1 = round_to<T>(dequant(v1, sx * p.sqkv[r + 1]) + bqkv[r + 1]);
          } else {
            f0 = round_to<T>(v0 + bqkv[r]);
            f1 = round_to<T>(v1 + bqkv[r + 1]);
          }
          if (part == 0) {
            f0 = round_to<T>(f0 * scale);
            f1 = round_to<T>(f1 * scale);
          }
        }
        if (part == 2)
          put_v<T, D::kLdVw>(Vh, m, d, f0, f1);
        else
          put2<T>(part == 0 ? Qh : Kh, d, m, f0, f1);
      });
    }
    __syncthreads();
    {  // probabilities: this warp's 16 queries by keys 16 ni .. 16 ni + 15
      float qk[2][2][4] = {};   // two sums a tile (even and odd k-steps): shorter chains
      for (int k0 = 0; k0 < hdw; k0 += 16) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ks = k0 + 8 * e;
          if (ks >= hdw) break;
          uint32_t a[4], al[4];
          load_a<kAttn>(a, al, Qh, m0, ks, hdw);
#pragma unroll
          for (int jt = 0; jt < 2; ++jt) {
            const int at = (ks + tq) * kLdA + 16 * ni + 8 * jt + g;
            mma_tile_raw<kAttn>(qk[e][jt], a, al, Kh[at], Kh[at + 4 * kLdA]);
          }
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int jt = 0; jt < 2; ++jt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          sc[jt][r] += qk[0][jt][r] + qk[1][jt][r];   // (bias + mask) + q.k, as the plain version
          mx[r >> 1] = fmaxf(mx[r >> 1], sc[jt][r]);
        }
      float* rmax = red;
      float* rsum = red + 4 * kTok;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        if (tq == 0) rmax[ni * kTok + m0 + g + 8 * i] = mx[i];
      }
      __syncthreads();
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = m0 + g + 8 * i;
        mx[i] = fmaxf(fmaxf(rmax[q], rmax[kTok + q]), fmaxf(rmax[2 * kTok + q], rmax[3 * kTok + q]));
      }
#pragma unroll
      for (int jt = 0; jt < 2; ++jt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          sc[jt][r] = expf(sc[jt][r] - mx[r >> 1]);
          sum[r >> 1] += sc[jt][r];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        if (tq == 0) rsum[ni * kTok + m0 + g + 8 * i] = sum[i];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = m0 + g + 8 * i;
        sum[i] = rsum[q] + rsum[kTok + q] + rsum[2 * kTok + q] + rsum[3 * kTok + q];
      }
#pragma unroll
      for (int jt = 0; jt < 2; ++jt)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          put2<T>(Pm, 16 * ni + 8 * jt + 2 * tq, m0 + g + 8 * i,
                  round_to<T>(sc[jt][2 * i] / sum[i]), round_to<T>(sc[jt][2 * i + 1] / sum[i]));
    }
    __syncthreads();
    // the head's output: 16 queries by head features d0 .. d0 + 7, d0 = 8 ni (+ 32)
#pragma unroll
    for (int pv = 0; pv < D::kPv; ++pv) {
      const int d0 = 8 * ni + 32 * pv;
      if (d0 >= hdp) break;
      float oo[2][4] = {};   // even and odd k-steps
#pragma unroll
      for (int ks = 0; ks < kTok / P; ks += 8) {
        uint32_t a[4], al[4];
        load_a<kAttn>(a, al, Pm, m0, ks, kTok / P);
        const int at = (ks + tq) * D::kLdVw + d0 + g;
        mma_tile_raw<kAttn>(oo[(ks >> 3) & 1], a, al, Vh[at], Vh[at + 4 * D::kLdVw]);
      }
      float o[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) o[r] = oo[0][r] + oo[1][r];
      const int d = d0 + 2 * tq;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (d < hd)
          put2<S>(AO, h * hd + d, m0 + g + 8 * i, round_to<T>(o[2 * i]), round_to<T>(o[2 * i + 1]));
      }
    }
    __syncthreads();
  }

  // y = x + s1 * (proj + bproj), in registers
  AccW accp[D::kNc][4] = {};
  float sa = 0.f;
  if constexpr (kInt8) {
    sa = quantize_window(XN, C, Cp, n, Q8, red);
    keep_quantised(1, C, sa, Q8, 0, C);
  }
  weight_product<kW>(accp, kInt8 ? Q8 : AO, proj_rows);
  fc1_rows(0).prefetch();
  float y[D::kNc][4];
#pragma unroll
  for (int jj = 0; jj < D::kNc; ++jj)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int o = 8 * (ni + 4 * jj) + 2 * tq, m = m0 + g + 8 * i;
      float v0 = 0.f, v1 = 0.f;
      if (o < C && m < n) {
        const float2 xv = load2(x + offset(m) + o);
        if constexpr (kInt8) {
          v0 = dequant(accp[jj][2 * i], sa * p.sproj[o]) + bproj[o] + xv.x;
          v1 = dequant(accp[jj][2 * i + 1], sa * p.sproj[o + 1]) + bproj[o + 1] +
               xv.y;
        } else {
          v0 = accp[jj][2 * i] + bproj[o];
          v1 = accp[jj][2 * i + 1] + bproj[o + 1];
          v0 = p.s1 ? v0 * s1 + xv.x : v0 + xv.x;
          v1 = p.s1 ? v1 * s1 + xv.y : v1 + xv.y;
        }
      }
      y[jj][2 * i] = v0;
      y[jj][2 * i + 1] = v1;
    }
  {  // LN2(y) into XN
    float mu[2], inv[2];
    row_stats<D::kNc>(y, C, red, mu, inv);
#pragma unroll
    for (int jj = 0; jj < D::kNc; ++jj) {
      const int o = 8 * (ni + 4 * jj) + 2 * tq;
      if (o >= C) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        put2<S>(XN, o, m0 + g + 8 * i,
                round_to<S>((y[jj][2 * i] - mu[i]) * inv[i] * p.ln2_w[o] + p.ln2_b[o]),
                round_to<S>((y[jj][2 * i + 1] - mu[i]) * inv[i] * p.ln2_w[o + 1] + p.ln2_b[o + 1]));
    }
  }
  __syncthreads();

  AccW acc2[D::kNc][4] = {};   // fc2
  float sh = 0.f;
  if constexpr (kWide) {
    // fc1 twice over the hidden chunks: for GELU's absmax over the window,
    // then to quantise each chunk at sh into XN's dead rows for its part of
    // fc2 (exact int32 sums, whatever the chunks)
    const float sy = quantize_window(XN, C, Cp, n, Q8, red);
    keep_quantised(2, C, sy, Q8, 0, C);
    auto gelu_at = [&](int r, int v) { return gelu(dequant(v, sy * p.sw1[r]) + b1[r]); };
    float mx = 0.f;
    for (int j0 = 0; j0 < hidden; j0 += kHid) {
      int acc1[3][4] = {};
      weight_product<kS8>(acc1, Q8, fc1_rows(j0));
      fc1_rows(j0 + kHid < hidden ? j0 + kHid : 0).prefetch();
      for_each_pair<3>(acc1, min(kHid, hidden - j0), [&](int m, int o, int v0, int v1) {
        if (m < n)
          mx = fmaxf(mx, fmaxf(fabsf(gelu_at(j0 + o, v0)), fabsf(gelu_at(j0 + o + 1, v1))));
      });
    }
    sh = window_scale(mx, red);
    const float inv = 1.f / sh;
    uint32_t* QG = XN;   // a chunk's quantised words: kHid / 4 rows
    for (int j0 = 0; j0 < hidden; j0 += kHid) {
      const int hc = min(kHid, hidden - j0);
      const auto fc2_rows = weights<kK, 4, D::kRows>(hc / 4, C, [&, j0](int o) {
        return wrow(p.w2, o, Hp) + j0 / 4;
      }, stages, p.x);
      int acc1[3][4] = {};
      weight_product<kS8>(acc1, Q8, fc1_rows(j0));
      fc2_rows.prefetch();
      for_each_pair<3>(acc1, hc, [&](int m, int o, int v0, int v1) {   // tokens >= n: zero
        const int q0 = m < n ? quantize(gelu_at(j0 + o, v0), inv) : 0;
        const int q1 = m < n ? quantize(gelu_at(j0 + o + 1, v1), inv) : 0;
        reinterpret_cast<uint16_t*>(QG)[((o >> 2) * kLdA + m) * 2 + ((o >> 1) & 1)] =
            static_cast<uint16_t>((q0 & 0xff) | (q1 & 0xff) << 8);
      });
      __syncthreads();
      keep_quantised(3, hidden, sh, QG, j0, hc);
      weight_product<kS8>(acc2, QG, fc2_rows);
      if (j0 + kHid < hidden) fc1_rows(j0 + kHid).prefetch();
    }
  } else if constexpr (kInt8) {
    const auto fc2_rows = weights<kK, 4>(Hp / 4, C, [&](int o) { return wrow(p.w2, o, Hp); },
                                         stages, p.x);
    const float sy = quantize_window(XN, C, Cp, n, Q8, red);
    keep_quantised(2, C, sy, Q8, 0, C);
    for (int j0 = 0; j0 < hidden; j0 += kHid) {   // GELU(fc1), all hidden rows, over XN
      int acc1[3][4] = {};
      weight_product<kS8>(acc1, Q8, fc1_rows(j0));
      if (j0 + kHid < hidden)
        fc1_rows(j0 + kHid).prefetch();
      else
        fc2_rows.prefetch();
      for_each_pair<3>(acc1, min(kHid, hidden - j0), [&](int m, int o, int v0, int v1) {
        const int r = j0 + o;
        put2<float>(XN, r, m, gelu(dequant(v0, sy * p.sw1[r]) + b1[r]),
                    gelu(dequant(v1, sy * p.sw1[r + 1]) + b1[r + 1]));
      });
    }
    __syncthreads();
    sh = quantize_window(XN, hidden, Hp, n, Q8, red);
    keep_quantised(3, hidden, sh, Q8, 0, hidden);
    weight_product<kS8>(acc2, Q8, fc2_rows);
  } else {
    for (int j0 = 0; j0 < hidden; j0 += kHid) {
      const int hc = min(kHid, hidden - j0);
      const auto fc2_rows = weights<kK, kCopyRows>(hc / P, C, [&](int o) {
        return wrow(p.w2, static_cast<size_t>(o) * hidden + j0, 1);
      }, stages, p.x);
      float acc1[3][4] = {};
      weight_product<kW>(acc1, XN, fc1_rows(j0));
      fc2_rows.prefetch();
      for_each_pair<3>(acc1, hc, [&](int m, int o, float v0, float v1) {
        put2<T>(HB, o, m, round_to<T>(gelu(v0 + b1[j0 + o])),
                round_to<T>(gelu(v1 + b1[j0 + o + 1])));
      });
      __syncthreads();
      weight_product<kW>(acc2, HB, fc2_rows);
      if (j0 + kHid < hidden) fc1_rows(j0 + kHid).prefetch();
    }
  }

  // out = y + s2 * (fc2 + b2)
#pragma unroll
  for (int jj = 0; jj < D::kNc; ++jj)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int o = 8 * (ni + 4 * jj) + 2 * tq, m = m0 + g + 8 * i;
      if (o >= C || m >= n) continue;
      float v0, v1;
      if constexpr (kInt8) {
        v0 = dequant(acc2[jj][2 * i], sh * p.sw2[o]) + b2[o] + y[jj][2 * i];
        v1 = dequant(acc2[jj][2 * i + 1], sh * p.sw2[o + 1]) + b2[o + 1] + y[jj][2 * i + 1];
      } else {
        v0 = acc2[jj][2 * i] + b2[o];
        v1 = acc2[jj][2 * i + 1] + b2[o + 1];
        v0 = p.s2 ? v0 * s2 + y[jj][2 * i] : v0 + y[jj][2 * i];
        v1 = p.s2 ? v1 * s2 + y[jj][2 * i + 1] : v1 + y[jj][2 * i + 1];
      }
      store2(out + offset(m) + o, v0, v1);
    }
}

template <typename T, bool kInt8, bool kWide>
int launch_joint(const JointParams& p, cudaStream_t stream) {
  const size_t smem = joint_smem_bytes(sizeof(T) == 4 ? 0 : 1, p.channels, p.heads, p.hidden, kInt8);
  cudaError_t err = cudaFuncSetAttribute(swin_block_joint_kernel<T, kInt8, kWide>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = p.batch * (p.height / p.window) * (p.width / p.window);
  swin_block_joint_kernel<T, kInt8, kWide><<<blocks, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kInt8>
int launch_joint(const JointParams& p, cudaStream_t stream) {
  if (joint_takes(p.channels, p.heads)) return launch_joint<T, kInt8, false>(p, stream);
  if constexpr (kInt8) return launch_joint<T, true, true>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 float32, 1 bfloat16. Returns the cudaError_t of the launch (0 on
// success); cudaErrorInvalidValue for a shape the kernel does not take (past
// joint_takes' widths, the int8 kernel's past wide_takes', a window over
// kTok tokens).
template <bool kInt8>
int launch_joint(int dtype, const JointParams& p, void* stream) {
  const bool takes = kInt8 ? wide_takes(p.channels, p.heads) : joint_takes(p.channels, p.heads);
  if (!takes || p.window * p.window > kTok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_joint<float, kInt8>(p, s);
  if (dtype == 1) return launch_joint<__nv_bfloat16, kInt8>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace swin
