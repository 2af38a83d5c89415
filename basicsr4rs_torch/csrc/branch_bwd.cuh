// Device code of the two branch backward kernels, K3 (swin_attn_block_bwd.cu)
// and K5 (mlp_block_bwd.cu), whose products all run on the tensor cores:
//
// - token-major operands: a buffer of T in shared memory holds a row a
//   token, pitch = 4 mod 8 words, so that a fragment's word loads and
//   ldmatrix's rows hit distinct banks. A product whose K is the features
//   reads the words as they are (frag_a, frag_b); one whose K is the tokens
//   reads the same buffer transposed (frag_a_t, frag_b_t): in float32 by
//   index, in bfloat16 by ldmatrix.trans, which packs two tokens of a
//   feature into a word. No second copy is kept;
// - the products: 3xTF32 m16n8k8 in float32 with a truncating hi/lo split
//   (plain TF32's 2^-11 would leave the float32 tolerance), m16n8k16 in
//   bfloat16, float32 sums; smem_product for two operands in shared memory,
//   streamed_product for weights streamed from L2 through kStages
//   shared-memory stages by cp.async;
// - red_tile4: a 16 x 8 tile of sums added into device memory as float4
//   vector reductions (weight gradients, dL/dLN(x));
// - the LayerNorm backward launch: from x, dz and the float32 (tokens, C)
//   buffer of dL/dLN(x) that the branch kernel filled, dx (+ dz), d ln_w,
//   d ln_b and the bias gradient of the branch's last linear (sum of s dz).

#pragma once

#include "swin_block_joint.cuh"

namespace swin {

constexpr int kMaxC = 256;        // LayerNorm backward: 8 features a lane
constexpr int kKw = 32;           // words of K a weight stage of dL/dLN(x) holds
constexpr int kSmemLimit = 232448;   // bytes of shared memory a block can opt in to
constexpr int kStages = 3;        // weight stages: two in flight while one is read

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// row pitch of a buffer of `words` words: a multiple of 8 plus 4
__host__ __device__ inline int pitch(int words) { return (words + 7) / 8 * 8 + 4; }

// --------------------------------------------------------- token-major words
// feature c of row t of a buffer of T with pitch ld words
template <typename T>
__device__ __forceinline__ float get1(const uint32_t* X, int ld, int t, int c) {
  if constexpr (sizeof(T) == 4)
    return __uint_as_float(X[t * ld + c]);
  else
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(X)[t * 2 * ld + c]);
}

template <typename T>
__device__ __forceinline__ void set1(uint32_t* X, int ld, int t, int c, float v) {
  if constexpr (sizeof(T) == 4)
    X[t * ld + c] = __float_as_uint(v);
  else
    reinterpret_cast<__nv_bfloat16*>(X)[t * 2 * ld + c] = __float2bfloat16(v);
}

// features c, c + 1 (c even) of row t
template <typename T>
__device__ __forceinline__ void set2(uint32_t* X, int ld, int t, int c, float v0, float v1) {
  if constexpr (sizeof(T) == 4)
    *reinterpret_cast<float2*>(X + t * ld + c) = make_float2(v0, v1);
  else
    X[t * ld + c / 2] = pack_bf16(v0, v1);
}

// LN of the n token rows of X (pitch ld words) in place, rounded to T, a
// warp a token (var = E[x^2] - mean^2, eps 1e-5); lw, lb: this lane's
// LayerNorm parameters, features lane + 32 i (zero past C).
template <typename T>
__device__ __forceinline__ void layer_norm_rows(uint32_t* X, int ld, int n, int C,
                                                const float (&lw)[kMaxC / 32],
                                                const float (&lb)[kMaxC / 32]) {
  constexpr int kI = kMaxC / 32;
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < n; t += kWarps) {
    float v[kI], sum = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < C ? get1<T>(X, ld, t, c) : 0.f;
      sum += v[i];
      ss += v[i] * v[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const float mean = sum / C, inv = rsqrtf(ss / C - mean * mean + 1e-5f);
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      const int c = lane + 32 * i;
      if (c < C) set1<T>(X, ld, t, c, round_to<T>((v[i] - mean) * inv * lw[i] + lb[i]));
    }
  }
}

// ----------------------------------------------------------------- fragments
// A fragment (rows m0 .. m0 + 15, words kw .. kw + 7 of K) of a matrix
// stored with its rows along M, by one ldmatrix: matrix j is rows m0 + 8 (j
// % 2) .., words kw + 4 (j / 2) .. (a 16-byte row of 8 x 8 b16 is four words
// of either type; pitch = 4 mod 8 words puts the 8 rows in distinct banks)
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const uint32_t* X, int ld, int m0,
                                       int kw) {
  const int lane = threadIdx.x & 31, j = lane >> 3;
  tc::ldmatrix_x4(a, static_cast<uint32_t>(__cvta_generic_to_shared(
                         X + (m0 + (lane & 7) + 8 * (j & 1)) * ld + kw + 4 * (j >> 1))));
}

// the same of a matrix stored with its rows along K (M contiguous)
template <typename T>
__device__ __forceinline__ void frag_a_t(uint32_t (&a)[4], const uint32_t* X, int ld, int m0,
                                         int kw) {
  const int lane = threadIdx.x & 31;
  if constexpr (sizeof(T) == 4) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = X[(kw + t + 4 * (r >> 1)) * ld + m0 + g + 8 * (r & 1)];
  } else {   // matrix j: rows (k) 16 kw .. + 8 (j / 2), columns (m) m0 + 8 (j % 2)
    const int j = lane >> 3, k = 2 * kw + 8 * (j >> 1) + (lane & 7), m = m0 + 8 * (j & 1);
    tc::ldmatrix_x4_trans(a, static_cast<uint32_t>(__cvta_generic_to_shared(X)) +
                                 (k * 2 * ld + m) * 2);
  }
}

// B fragment (columns n0 .. n0 + 7, words kw .. kw + 7 of K) of a matrix
// stored with its rows along N, by one ldmatrix: words kw .. and kw + 4 ..
__device__ __forceinline__ void frag_b(uint32_t (&b)[2], const uint32_t* X, int ld, int n0,
                                       int kw) {
  const int lane = threadIdx.x & 31;
  tc::ldmatrix_x2(b, static_cast<uint32_t>(__cvta_generic_to_shared(
                         X + (n0 + (lane & 7)) * ld + kw + 4 * ((lane >> 3) & 1))));
}

// the same of a matrix stored with its rows along K
template <typename T>
__device__ __forceinline__ void frag_b_t(uint32_t (&b)[2], const uint32_t* X, int ld, int n0,
                                         int kw) {
  const int lane = threadIdx.x & 31;
  if constexpr (sizeof(T) == 4) {
    const int at = (kw + (lane & 3)) * ld + n0 + (lane >> 2);
    b[0] = X[at];
    b[1] = X[at + 4 * ld];
  } else {   // matrix j: rows (k) 16 kw + 8 j .., columns n0 ..
    const int k = 2 * kw + 8 * ((lane >> 3) & 1) + (lane & 7);
    tc::ldmatrix_x2_trans(b, static_cast<uint32_t>(__cvta_generic_to_shared(X)) +
                                 (k * 2 * ld + n0) * 2);
  }
}

// 3xTF32 by truncation: hi = v with its low 13 bits cleared (a TF32
// value), lo = v - hi exactly, whose low 13 bits the tensor cores ignore.
// hi hi' + hi lo' + lo hi' keeps about 2^-20 of v w (the rounding split of
// tensor_core.cuh 2^-21) without its two conversions a word, which cost
// more than the three products.
__device__ __forceinline__ void split_fast(uint32_t v, uint32_t& hi, uint32_t& lo) {
  hi = v & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(v) - __uint_as_float(hi));
}

template <Route R>
__device__ __forceinline__ void split_a(uint32_t (&a)[4], uint32_t (&al)[4]) {
  if constexpr (R == kTF32x3) {
#pragma unroll
    for (int r = 0; r < 4; ++r) split_fast(a[r], a[r], al[r]);
  }
}

// c += a . b on one 16 x 8 tile; TF32: b split here, then the three
// products, the small ones first
template <Route R>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&a)[4],
                                     const uint32_t (&al)[4], uint32_t b0, uint32_t b1) {
  if constexpr (R == kTF32x3) {
    uint32_t bl0, bl1;
    split_fast(b0, b0, bl0);
    split_fast(b1, b1, bl1);
    tc::mma_tf32(c, al, b0, b1);
    tc::mma_tf32(c, a, bl0, bl1);
    tc::mma_tf32(c, a, b0, b1);
  } else {
    tc::mma_bf16(c, a, b0, b1);
  }
}

// f(m, n, v_n, v_n+1) over this lane's pairs of the 16 x 8 tile at (m0, n0)
template <class F>
__device__ __forceinline__ void tile_pairs(const float (&c)[4], int m0, int n0, F f) {
  const int lane = threadIdx.x & 31, m = m0 + (lane >> 2), n = n0 + 2 * (lane & 3);
  f(m, n, c[0], c[1]);
  f(m + 8, n, c[2], c[3]);
}

// Adds the 16 x 8 tile at (m0, n0) into device memory four columns at a
// time: at(m, n) is the address of columns n .. n + 3 (n % 4 == 0) of row
// m, or nullptr to skip them. Lanes 2i and 2i + 1 trade a pair, so that one
// holds row g's four columns and the other row g + 8's. Warp-uniform.
template <class At>
__device__ __forceinline__ void red_tile4(const float (&c)[4], int m0, int n0, At at) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool odd = t & 1;
  const float r0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
  const float r1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
  const int m = m0 + g + (odd ? 8 : 0), n = n0 + 2 * (t & 2);
  float* p = at(m, n);
  if (p != nullptr)
    atomicAdd(reinterpret_cast<float4*>(p),
              odd ? make_float4(r0, r1, c[2], c[3]) : make_float4(c[0], c[1], r0, r1));
}

// ------------------------------------------------------------------ products
// C (M x N) = A (M x K words) . B for operands in shared memory, in tiles
// of 16 x 8 WN dealt to the warps in turn. la(a, m0, kw) and lb(b, n0, kw)
// load raw fragments; epi(m0, n0, c) gets each 16 x 8 tile's sums (tiles
// past N are skipped; rows past M are computed from whatever the buffers
// hold there and must be dropped).
template <Route R, int WN, class LA, class LB, class Epi>
__device__ __forceinline__ void smem_product(int M, int N, int Kw, LA la, LB lb, Epi epi) {
  const int mt = (M + 15) / 16, nt = (N + 8 * WN - 1) / (8 * WN);
  for (int tile = threadIdx.x >> 5; tile < mt * nt; tile += kWarps) {
    const int m0 = 16 * (tile % mt), n0 = 8 * WN * (tile / mt);
    float c[2][WN][4] = {};   // even and odd k-steps: shorter chains
#pragma unroll 1
    for (int kw = 0; kw < Kw; kw += 16)   // Kw % 16 == 0
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint32_t a[4], al[4], b[2];
        la(a, m0, kw + 8 * e);
        split_a<R>(a, al);
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          if (n0 + 8 * j >= N) break;
          lb(b, n0 + 8 * j, kw + 8 * e);
          mma3<R>(c[e][j], a, al, b[0], b[1]);
        }
      }
#pragma unroll
    for (int j = 0; j < WN; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) c[0][j][r] += c[1][j][r];
      if (n0 + 8 * j < N) epi(m0, n0 + 8 * j, c[0][j]);
    }
  }
}

// cp.async of `rows` rows of `words` words (pitch ld) into shared memory,
// a warp a row: word q of row r from row(r) + q where row(r) is not nullptr
// and q < valid, else zeros; one commit group.
template <int kCopy, class Row>
__device__ __forceinline__ void stage_in(uint32_t* st, int ld, int rows, int words, int valid,
                                         Row row, const void* any) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += kWarps) {
    const uint32_t* src = row(r);
    for (int q = kCopy * lane; q < words; q += 32 * kCopy) {
      const bool ok = src != nullptr && q < valid;
      cp_async_zfill<kCopy>(st + r * ld + q, ok ? static_cast<const void*>(src + q) : any, ok);
    }
  }
  cp_async_commit();
}

// acc += A . W for the 64 tokens against weights streamed through the
// kStages stages of kK words of K: warp w owns the tokens 16 (w % 4) .. and
// the n8 tiles w / 4 + 4 jj below N. in(step) issues a step's stage (one
// commit group, empty past the last); its steps 0 and 1 have been issued.
// kBT: a stage holds rows of K, else rows of N, ld words a row. la(a, m0, kw)
// loads A's fragment at word kw of K. Begins with the block in step on A;
// ends with every warp done with A and the stages.
template <Route R, typename T, int NT, bool kBT, class In, class LA>
__device__ __forceinline__ void streamed_product(float (&acc)[NT][4], int Kw, int kK, int N,
                                                 int ld, uint32_t* stages, int stage_words,
                                                 In in, LA la) {
  const int warp = threadIdx.x >> 5, m0 = (warp & 3) * 16, wn = warp >> 2;
  const int steps = (Kw + kK - 1) / kK;
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // this step's stage has landed, the one read last step is free
    in(step + kStages - 1);
    const uint32_t* st = stages + (step % kStages) * stage_words;
    const int kw0 = step * kK, kn = min(kK, Kw - kw0);
#pragma unroll 1
    for (int ks = 0; ks < kn; ks += 8) {
      uint32_t a[4], al[4];
      la(a, m0, kw0 + ks);
      split_a<R>(a, al);
#pragma unroll
      for (int jj = 0; jj < NT; ++jj) {
        const int n0 = 8 * (wn + 4 * jj);
        if (n0 >= N) break;
        uint32_t b[2];
        if constexpr (kBT)
          frag_b_t<T>(b, st, ld, n0, ks);
        else
          frag_b(b, st, ld, n0, ks);
        mma3<R>(acc[jj], a, al, b[0], b[1]);
      }
    }
  }
  __syncthreads();
}

// ------------------------------------------------------- the LayerNorm backward
struct LnBackwardParams {
  const void* x;    // (tokens, C), T
  const void* dz;   // the output's cotangent, T
  void* dx;         // T
  const float* dln;   // (tokens, C): dL/dLN(x), summed by the branch kernel
  int tokens, channels, tokens_per_sample, mode;
  const float* ln_w;
  const float* s;   // (samples,) when mode == kScaled
  // float32 gradients, zeroed before the launch
  float* dln_w;
  float* dln_b;
  float* dbias;     // sum over the tokens of s dz: the branch's last bias
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]), b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// dx = LN backward of dL/dLN(x) (+ dz unless in branch mode), and the sums
// over the tokens of d ln_w, d ln_b and s dz: a warp a token, four features
// a lane (C % 4 == 0, C <= kMaxC).
template <typename T>
__global__ void __launch_bounds__(kThreads) branch_ln_bwd_kernel(const LnBackwardParams p) {
  constexpr int kI = kMaxC / 128;
  __shared__ float sums[3 * kMaxC];   // d ln_w, d ln_b, s dz of the block
  const int C = p.channels, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* x = static_cast<const T*>(p.x);
  const T* dz = static_cast<const T*>(p.dz);
  T* dx = static_cast<T*>(p.dx);
  for (int e = threadIdx.x; e < 3 * C; e += kThreads) sums[e] = 0.f;
  __syncthreads();
  float gw[kI][4] = {}, gb[kI][4] = {}, gp[kI][4] = {};
  for (int tok = blockIdx.x * kWarps + warp; tok < p.tokens; tok += gridDim.x * kWarps) {
    const float s = p.mode == kScaled ? p.s[tok / p.tokens_per_sample] : 1.f;
    const size_t at = static_cast<size_t>(tok) * C;
    float xv[kI][4], dv[kI][4], zv[kI][4];
    float sx = 0.f, sxx = 0.f;
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      const int c = 4 * lane + 128 * i;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), d = a, z = a;
      if (c < C) {
        a = load4(x + at + c);
        d = load4(p.dln + at + c);
        z = load4(dz + at + c);
      }
      xv[i][0] = a.x, xv[i][1] = a.y, xv[i][2] = a.z, xv[i][3] = a.w;
      dv[i][0] = d.x, dv[i][1] = d.y, dv[i][2] = d.z, dv[i][3] = d.w;
      zv[i][0] = z.x, zv[i][1] = z.y, zv[i][2] = z.z, zv[i][3] = z.w;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sx += xv[i][j];
        sxx += xv[i][j] * xv[i][j];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sx += __shfl_xor_sync(0xffffffffu, sx, o);
      sxx += __shfl_xor_sync(0xffffffffu, sxx, o);
    }
    const float mean = sx / C, inv = rsqrtf(sxx / C - mean * mean + 1e-5f);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      const int c = 4 * lane + 128 * i;
      if (c >= C) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xh = (xv[i][j] - mean) * inv, dg = dv[i][j] * p.ln_w[c + j];
        xv[i][j] = xh;
        s1 += dg;
        s2 += dg * xh;
        gw[i][j] += dv[i][j] * xh;
        gb[i][j] += dv[i][j];
        gp[i][j] += s * zv[i][j];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float m1 = s1 / C, m2 = s2 / C;
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      const int c = 4 * lane + 128 * i;
      if (c >= C) continue;
      float out[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        out[j] = inv * (dv[i][j] * p.ln_w[c + j] - m1 - xv[i][j] * m2);
        if (p.mode != kBranch) out[j] += zv[i][j];
      }
      store4(dx + at + c, out);
    }
  }
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    const int c = 4 * lane + 128 * i;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      atomicAdd(sums + c + j, gw[i][j]);
      atomicAdd(sums + C + c + j, gb[i][j]);
      atomicAdd(sums + 2 * C + c + j, gp[i][j]);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    atomicAdd(p.dln_w + c, sums[c]);
    atomicAdd(p.dln_b + c, sums[C + c]);
    atomicAdd(p.dbias + c, sums[2 * C + c]);
  }
}

constexpr int kLnBlocks = 132;   // one wave of the LayerNorm backward on an H100

// Launches branch_ln_bwd_kernel on the stream; returns the cudaError_t.
template <typename T>
inline int launch_ln_backward(const LnBackwardParams& p, cudaStream_t stream) {
  const int blocks = imax(1, imin(kLnBlocks, (p.tokens + kWarps - 1) / kWarps));
  branch_ln_bwd_kernel<T><<<blocks, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace swin
