// Windowed multi-head attention from packed q|k|v, backward, every product
// on the tensor cores.
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
// nWb == 1. q * scale is rounded to the model dtype T, and so are P and dS
// where they feed the second product of a chain; the softmax backward and
// dbias stay float32.
//
// What bounds it on an H100: bytes. A token brings 4C values in and takes
// 3C out for 10 n C FLOP (B=16 64x64, C=192, n=64: 365 MB with the bias and
// dbias, 0.109 ms at 3.35 TB/s in float32, 0.056 ms in bfloat16, against
// 8.05 GFLOP, 0.049 ms as 3xTF32 at 495 TFLOP/s). The first route ran the
// five products on the CUDA cores (11% of their 0.120 ms bound, slower than
// SDPA's backward); now each is an mma.sync (tensor_core.cuh, over
// branch_bwd.cuh's fragments, as K3 and K5): 3xTF32 m16n8k8 in float32 with
// the truncating hi/lo split, m16n8k16 in bfloat16, float32 sums.
//
// The unit: one thread block a (window position, head, group of samples),
// NT warps with n padded to 16 NT tokens (NT = 4 up to 64 tokens, 6 up to
// 96: window 9's 81). Warp w owns the queries 16w .. 16w + 15 of S, P, dP
// and dS, and the rows 16w .. of dV, dQ and dK.
// - Operands: q, k, v and dO sit token-major in shared memory, pitch = 4
//   mod 8 words, the head dim padded to a multiple of 16 with zeros (30 ->
//   32), the tokens past n zero. S and dP (K = the head dim) read the words
//   as they are; dV, dQ and dK (K = the tokens) read P, dS, dO, k and q
//   transposed: by index in float32, by ldmatrix.trans in bfloat16. No
//   second copy is kept.
// - Softmax and rowsum(dP * P) work on the accumulator fragments: a row's
//   entries sit in one quad of lanes, so they reduce by two shuffles; P and
//   dP never leave registers for them. P (rounded to T) goes to shared
//   memory once, for dV; dS replaces it in place for dQ and dK. Padded keys
//   get P = 0 through -inf before the max, padded queries P = 0; neither is
//   written. A row is normalised by one reciprocal of its sum, not by a
//   division an entry: under the shift mask's -100 most entries of P are
//   denormal, and there the IEEE division takes its slow path (the shifted
//   call took 1.4 times the unshifted one's time, in bfloat16 1.75 times).
// - The group: dbias sums dS over the group's samples in registers and
//   leaves the block once, by float4 vector reductions where a row of n
//   floats keeps 16-byte alignment (n % 4 == 0) and scalar atomicAdd
//   otherwise; the order of those adds, hence dbias's last bits, changes
//   from run to run. The bias slab of the unit comes in once. The next
//   sample's q, k, v and dO come in by cp.async while the current one
//   computes, in a second stage, unless one stage lets an SM hold more
//   blocks: the products of one block are a chain of dependent latencies
//   (fragment loads, mma.sync, shuffles), so more blocks an SM hide more of
//   them than the early copy does (float32 at 64 tokens: three blocks of one
//   stage rather than two of two). The group's size is chosen on the
//   host from the blocks an SM holds: the one that minimises the grid's
//   waves times (samples a unit + 1), a unit's own work (its bias slab, its
//   dbias adds) counted as one sample more. Without that term window 9's
//   72x72 maps ran a sample a unit, 6144 units reloading their slabs and
//   adding 6561 scalar atomics each, 1.25 times as slow.
// - dqkv is written once, from the accumulators into its place in (B, H, W,
//   3C), by window addressing: no partition copy.

#include <algorithm>

#include "branch_bwd.cuh"
#include "window_attention.cuh"

namespace {

using swin::Route;
using swin::frag_a;
using swin::frag_a_t;
using swin::frag_b;
using swin::frag_b_t;
using swin::mma3;
using swin::pitch;
using swin::round_up16;
using swin::set2;
using swin::split_a;
using wattn::Geometry;
using wattn::kMaxHeadDim;
using wattn::kMaxTokens;

constexpr int kMaxHt = kMaxHeadDim / 8;   // n8 tiles of the padded head dim

__host__ __device__ constexpr int warps_of(int n) { return n <= 64 ? 4 : 6; }

// Word offsets of the buffers; P features of T a word (1 float32, 2 bfloat16)
struct Layout {
  int ldB, ldH, ldP;   // pitches: the bias (floats), q/k/v/dO (words), P/dS (words)
  int bias, stage, ps, tokens, words;   // offsets; a stage holds q, k, v, dO
};

__host__ __device__ inline Layout layout_of(int channels, int heads, int window, int P,
                                            int stages) {
  const int np = 16 * warps_of(window * window), hdp = round_up16(channels / heads);
  Layout l;
  l.ldB = np + 8;   // float2 reads of a quad's rows hit distinct banks
  l.ldH = pitch(hdp / P);
  l.ldP = pitch(np / P);
  l.bias = 0;
  l.stage = l.bias + np * l.ldB;
  l.ps = l.stage + stages * 4 * np * l.ldH;
  l.tokens = l.ps + np * l.ldP;
  l.words = l.tokens + np;
  return l;
}

size_t smem_bytes(int dtype, int channels, int heads, int window, int stages) {
  return static_cast<size_t>(layout_of(channels, heads, window, dtype + 1, stages).words) * 4;
}

// The four buffers of one sample: q (scaled in place), k, v, dO
struct Stage {
  uint32_t* q;
  uint32_t* k;
  uint32_t* v;
  uint32_t* dout;
};

// acc(m, j) = sum_d A[m0 + m][d] B[j][d] for this warp's 16 rows m and the
// J n8 tiles of keys j: S (A = scale q, B = k) and dP (A = dO, B = v), K =
// the Hw words of the padded head dim, both token-major
template <Route R, int J>
__device__ __forceinline__ void score_product(float (&acc)[J][4], const uint32_t* A,
                                            const uint32_t* B, int ld, int m0, int Hw) {
#pragma unroll 1
  for (int kw = 0; kw < Hw; kw += 8) {
    uint32_t a[4], al[4], b[2];
    frag_a(a, A, ld, m0, kw);
    split_a<R>(a, al);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      frag_b(b, B, ld, 8 * j, kw);
      mma3<R>(acc[j], a, al, b[0], b[1]);
    }
  }
}

// Blocks an SM a launch is compiled for: three at 64 tokens (168 registers);
// at 96, two in bfloat16 (one stage each, 168 registers with a few spilled:
// faster than one block of 255) and one in float32 (a block of one stage
// takes 134 KB of shared memory, so one fits anyway)
template <typename T, int NT>
__global__ void __launch_bounds__(32 * NT, NT == 4 ? 3 : sizeof(T) == 2 ? 2 : 1)
    window_attention_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                                const T* __restrict__ dout, T* __restrict__ dqkv,
                                float* __restrict__ dbias, const Geometry g,
                                const int samples_per_unit, const int stages) {
  constexpr Route R = sizeof(T) == 4 ? swin::kTF32x3 : swin::kBF16;
  constexpr int P = 4 / sizeof(T);
  constexpr int kThreads = 32 * NT, kNp = 16 * NT, kJt = 2 * NT;   // kJt: n8 tiles of keys
  extern __shared__ __align__(16) uint32_t smem[];

  const int C = g.channels, ws = g.window, n = ws * ws, hd = C / g.heads, hdp = round_up16(hd);
  const int Hw = hdp / P, Kp = kNp / P, ht = hdp / 8;   // words of the head dim and of the tokens
  const Layout L = layout_of(C, g.heads, ws, P, stages);
  const int ldB = L.ldB, ldH = L.ldH, ldP = L.ldP;
  const int nww = g.width / ws, nw = (g.height / ws) * nww;
  const int position = blockIdx.x % (nw * g.heads), h = position % g.heads, win = position / g.heads;
  const int first = blockIdx.x / (nw * g.heads) * samples_per_unit;
  const int last = min(g.batch, first + samples_per_unit);
  const float scale = g.scale;
  const size_t slab = (static_cast<size_t>(g.bias_windows == 1 ? 0 : win) * g.heads + h) * n * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gq = lane >> 2, tq = lane & 3;
  const int m0 = 16 * warp;

  const float* Bs = reinterpret_cast<const float*>(smem + L.bias);
  uint32_t* Ps = smem + L.ps;   // P, then dS: rows of queries
  int* at = reinterpret_cast<int*>(smem + L.tokens);   // token t's (row, column) in the image
  auto stage = [&](int s) {
    uint32_t* b = smem + L.stage + s * 4 * kNp * ldH;
    return Stage{b, b + kNp * ldH, b + 2 * kNp * ldH, b + 3 * kNp * ldH};
  };
  for (int t = threadIdx.x; t < kNp; t += kThreads)
    at[t] = t < n ? ((win / nww) * ws + t / ws) * g.width + (win % nww) * ws + t % ws : 0;
  // the unit's bias slab, rows of n floats at pitch ldB
  {
    uint32_t* dst = smem + L.bias;
    const float* src = bias + slab;
    if (n % 4 == 0) {
      for (int e = threadIdx.x; e < n * n / 4; e += kThreads) {
        const int r = 4 * e / n, c = 4 * e - r * n;
        swin::cp_async_zfill<4>(dst + r * ldB + c, src + 4 * e, true);
      }
    } else {
      for (int e = threadIdx.x; e < n * n; e += kThreads) {
        const int r = e / n;
        swin::cp_async_zfill<1>(dst + r * ldB + e - r * n, src + e, true);
      }
    }
  }
  __syncthreads();   // the token table

  // element offset of token t of sample img in a (B, H, W, ch) tensor
  auto token = [&](int img, int t, int ch) {
    return (static_cast<size_t>(img) * g.height * g.width + at[t]) * ch;
  };
  // q, k, v, dO of sample img into a stage: rows of hd elements, zero past
  // hd and past n; cp.async of kc words where every row start allows it
  const int kc = (C % (4 * P) == 0 && hd % (4 * P) == 0)   ? 4
                 : (C % (2 * P) == 0 && hd % (2 * P) == 0) ? 2
                 : (hd % P == 0)                           ? 1
                                                           : 0;
  auto load = [&](int img, const Stage& st) {
    uint32_t* dst[4] = {st.q, st.k, st.v, st.dout};
    if (kc == 0) {   // bfloat16 with an odd head dim: element by element
      for (int e = threadIdx.x; e < 4 * kNp * Hw * P; e += kThreads) {
        const int part = e / (kNp * Hw * P), r = e % (kNp * Hw * P), t = r / (Hw * P),
                  d = r % (Hw * P);
        float v = 0.f;
        if (t < n && d < hd)
          v = swin::to_f32(part < 3 ? qkv[token(img, t, 3 * C) + part * C + h * hd + d]
                                    : dout[token(img, t, C) + h * hd + d]);
        reinterpret_cast<T*>(dst[part])[t * ldH * P + d] = swin::from_f32<T>(v);
      }
      return;
    }
    const int per_row = Hw / kc, valid = hd / P;
    for (int e = threadIdx.x; e < 4 * kNp * per_row; e += kThreads) {
      const int part = e / (kNp * per_row), r = e % (kNp * per_row), t = r / per_row,
                q = (r % per_row) * kc;
      const bool ok = t < n && q < valid;
      const T* src = part < 3 ? qkv + (ok ? token(img, t, 3 * C) + part * C + h * hd : 0)
                              : dout + (ok ? token(img, t, C) + h * hd : 0);
      uint32_t* d = dst[part] + t * ldH + q;
      const void* s = reinterpret_cast<const uint32_t*>(src) + (ok ? q : 0);
      if (kc == 4)
        swin::cp_async_zfill<4>(d, s, ok);
      else if (kc == 2)
        swin::cp_async_zfill<2>(d, s, ok);
      else
        swin::cp_async_zfill<1>(d, s, ok);
    }
  };
  // dqkv's features d, d + 1 of token t, part 0 (q), 1 (k) or 2 (v)
  const bool paired = C % 2 == 0 && hd % 2 == 0;
  auto put = [&](int img, int t, int part, int d, float v0, float v1) {
    if (t >= n || d >= hd) return;
    T* p = dqkv + token(img, t, 3 * C) + part * C + h * hd + d;
    if (paired) {
      swin::store2(p, v0, v1);
    } else {
      p[0] = swin::from_f32<T>(v0);
      if (d + 1 < hd) p[1] = swin::from_f32<T>(v1);
    }
  };

  float db[kJt][4] = {};   // dbias of this warp's queries, summed over the group
  load(first, stage(0));
  swin::cp_async_commit();
  for (int img = first; img < last; ++img) {
    const int cur = stages == 2 ? (img - first) & 1 : 0;
    const Stage st = stage(cur);
    swin::cp_async_wait<0>();
    __syncthreads();   // this sample has landed; the last one's products are done
    if (stages == 2 && img + 1 < last) {
      load(img + 1, stage(cur ^ 1));
      swin::cp_async_commit();
    }
    // q * scale, rounded to T, in place: this warp's rows (S reads only them)
    for (int e = lane; e < 16 * Hw; e += 32) {
      uint32_t* w = st.q + (m0 + e / Hw) * ldH + e % Hw;
      if constexpr (P == 1) {
        *w = __float_as_uint(__uint_as_float(*w) * scale);
      } else {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w));
        *w = swin::pack_bf16(f.x * scale, f.y * scale);
      }
    }
    __syncwarp();

    // S = (scale q) k^T + bias, and P = softmax(S), in this warp's fragments
    float p[kJt][4] = {};
    score_product<R, kJt>(p, st.q, st.k, ldH, m0, Hw);
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kJt; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = m0 + gq + 8 * i, key = 8 * j + 2 * tq;
        const float2 bv = *reinterpret_cast<const float2*>(Bs + q * ldB + key);
        p[j][2 * i] = key >= n ? -INFINITY : q < n ? p[j][2 * i] + bv.x : 0.f;
        p[j][2 * i + 1] = key + 1 >= n ? -INFINITY : q < n ? p[j][2 * i + 1] + bv.y : 0.f;
        mx[i] = fmaxf(mx[i], fmaxf(p[j][2 * i], p[j][2 * i + 1]));
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
#pragma unroll
    for (int j = 0; j < kJt; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        p[j][r] = expf(p[j][r] - mx[r >> 1]);
        sum[r >> 1] += p[j][r];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      sum[i] = m0 + gq + 8 * i < n ? 1.f / sum[i] : 0.f;   // a padded query's row is zero
    }
#pragma unroll
    for (int j = 0; j < kJt; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) p[j][r] *= sum[r >> 1];
      swin::tile_pairs(p[j], m0, 8 * j, [&](int q, int key, float v0, float v1) {
        set2<T>(Ps, ldP, q, key, swin::round_to<T>(v0), swin::round_to<T>(v1));
      });
    }

    // dP = dO v^T; delta = rowsum(dP * P); dS = P (dP - delta), into dbias
    float dp[kJt][4] = {};
    score_product<R, kJt>(dp, st.dout, st.v, ldH, m0, Hw);
    float delta[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kJt; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) delta[r >> 1] = fmaf(dp[j][r], p[j][r], delta[r >> 1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 1);
      delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 2);
    }
#pragma unroll
    for (int j = 0; j < kJt; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        dp[j][r] = p[j][r] * (dp[j][r] - delta[r >> 1]);
        db[j][r] += dp[j][r];
      }
    __syncthreads();   // P is whole

    // dV = P^T dO: rows of keys
    {
      float c[kMaxHt][4] = {};
#pragma unroll 1
      for (int kw = 0; kw < Kp; kw += 8) {
        uint32_t a[4], al[4], b[2];
        frag_a_t<T>(a, Ps, ldP, m0, kw);
        split_a<R>(a, al);
#pragma unroll
        for (int jd = 0; jd < kMaxHt; ++jd) {
          if (jd >= ht) break;
          frag_b_t<T>(b, st.dout, ldH, 8 * jd, kw);
          mma3<R>(c[jd], a, al, b[0], b[1]);
        }
      }
#pragma unroll
      for (int jd = 0; jd < kMaxHt; ++jd) {
        if (jd >= ht) break;
        swin::tile_pairs(c[jd], m0, 8 * jd, [&](int t, int d, float v0, float v1) {
          put(img, t, 2, d, v0, v1);
        });
      }
    }
    __syncthreads();   // every warp has read P
#pragma unroll
    for (int j = 0; j < kJt; ++j)
      swin::tile_pairs(dp[j], m0, 8 * j, [&](int q, int key, float v0, float v1) {
        set2<T>(Ps, ldP, q, key, swin::round_to<T>(v0), swin::round_to<T>(v1));
      });
    __syncthreads();   // dS is whole

    // dQ = scale dS k: rows of queries; dK = dS^T (scale q): rows of keys
    {
      float cq[kMaxHt][4] = {}, ck[kMaxHt][4] = {};
#pragma unroll 1
      for (int kw = 0; kw < Kp; kw += 8) {
        uint32_t a[4], al[4], at_[4], atl[4], b[2];
        frag_a(a, Ps, ldP, m0, kw);
        split_a<R>(a, al);
        frag_a_t<T>(at_, Ps, ldP, m0, kw);
        split_a<R>(at_, atl);
#pragma unroll
        for (int jd = 0; jd < kMaxHt; ++jd) {
          if (jd >= ht) break;
          frag_b_t<T>(b, st.k, ldH, 8 * jd, kw);
          mma3<R>(cq[jd], a, al, b[0], b[1]);
          frag_b_t<T>(b, st.q, ldH, 8 * jd, kw);
          mma3<R>(ck[jd], at_, atl, b[0], b[1]);
        }
      }
#pragma unroll
      for (int jd = 0; jd < kMaxHt; ++jd) {
        if (jd >= ht) break;
        swin::tile_pairs(cq[jd], m0, 8 * jd, [&](int t, int d, float v0, float v1) {
          put(img, t, 0, d, scale * v0, scale * v1);
        });
        swin::tile_pairs(ck[jd], m0, 8 * jd, [&](int t, int d, float v0, float v1) {
          put(img, t, 1, d, v0, v1);
        });
      }
    }
    if (stages == 1 && img + 1 < last) {
      __syncthreads();   // every warp is done with the one stage
      load(img + 1, stage(0));
      swin::cp_async_commit();
    }
  }

  float* out = dbias + slab;
#pragma unroll
  for (int j = 0; j < kJt; ++j) {
    if (n % 4 == 0) {
      swin::red_tile4(db[j], m0, 8 * j, [&](int q, int key) {
        return q < n && key < n ? out + q * n + key : nullptr;
      });
    } else {
      swin::tile_pairs(db[j], m0, 8 * j, [&](int q, int key, float v0, float v1) {
        if (q < n && key < n) atomicAdd(out + q * n + key, v0);
        if (q < n && key + 1 < n) atomicAdd(out + q * n + key + 1, v1);
      });
    }
  }
}

// Blocks an SM holds with `stages` stages.
template <typename T, int NT>
cudaError_t occupancy(int dtype, const Geometry& g, int stages, int* per_sm) {
  const size_t smem = smem_bytes(dtype, g.channels, g.heads, g.window, stages);
  *per_sm = 0;
  if (smem > static_cast<size_t>(swin::kSmemLimit)) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(window_attention_bwd_kernel<T, NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, window_attention_bwd_kernel<T, NT>,
                                                       32 * NT, smem);
}

// The launch: two stages unless one stage lets an SM hold more blocks
// (float32 at 64 tokens: three blocks of one stage against two of two); and
// units = window positions x heads x groups of samples, the group the one
// that minimises waves x (samples a unit + 1), the time of the last wave's
// slowest block with a unit's own work (its bias slab, its dbias adds:
// scalar atomics at 81 tokens) counted as one sample more; the largest of
// those. plan = {units, samples a unit, blocks an SM, SMs, stages}.
template <typename T, int NT>
cudaError_t plan_of(int dtype, const Geometry& g, int (&plan)[5]) {
  int two = 0, one = 0, device = 0, sms = 0;
  cudaError_t err = occupancy<T, NT>(dtype, g, 2, &two);
  if (err == cudaSuccess) err = occupancy<T, NT>(dtype, g, 1, &one);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int stages = one > two ? 1 : 2, per_sm = stages == 1 ? one : two;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(   // the queries left it at the last one's size
      window_attention_bwd_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(dtype, g.channels, g.heads, g.window, stages)));
  if (err != cudaSuccess) return err;
  const long long positions =
      static_cast<long long>(g.height / g.window) * (g.width / g.window) * g.heads;
  const long long slots = static_cast<long long>(per_sm) * sms;
  long long best = -1;
  for (int chunks = 1; chunks <= g.batch; ++chunks) {
    const int group = (g.batch + chunks - 1) / chunks;
    if ((g.batch + group - 1) / group != chunks) continue;   // the same groups as fewer chunks
    const long long cost = (positions * chunks + slots - 1) / slots * (group + 1);
    if (best < 0 || cost < best) {
      best = cost;
      plan[0] = static_cast<int>(positions * chunks);
      plan[1] = group;
    }
  }
  plan[2] = per_sm;
  plan[3] = sms;
  plan[4] = stages;
  return cudaSuccess;
}

template <typename T, int NT>
int launch(int dtype, const void* qkv, const float* bias, const void* dout, void* dqkv,
           float* dbias, const Geometry& g, cudaStream_t stream) {
  int plan[5];
  cudaError_t err = plan_of<T, NT>(dtype, g, plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_bwd_kernel<T, NT>
      <<<plan[0], 32 * NT, smem_bytes(dtype, g.channels, g.heads, g.window, plan[4]), stream>>>(
          static_cast<const T*>(qkv), bias, static_cast<const T*>(dout), static_cast<T*>(dqkv),
          dbias, g, plan[1], plan[4]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int dtype, const void* qkv, const float* bias, const void* dout, void* dqkv,
           float* dbias, const Geometry& g, cudaStream_t stream) {
  if (warps_of(g.window * g.window) == 4)
    return launch<T, 4>(dtype, qkv, bias, dout, dqkv, dbias, g, stream);
  return launch<T, 6>(dtype, qkv, bias, dout, dqkv, dbias, g, stream);
}

bool takes(int channels, int heads, int window) {
  return window * window <= kMaxTokens && channels / heads <= kMaxHeadDim;
}

}  // namespace

extern "C" {

// Shared memory one thread block needs at least (one stage), in bytes;
// dtype 0 float32, 1 bfloat16.
size_t window_attention_bwd_smem_bytes(int dtype, int channels, int heads, int window) {
  return smem_bytes(dtype, channels, heads, window, 1);
}

// The grid the launch would use: plan = {units, samples a unit, blocks an
// SM, SMs, stages}. Returns the cudaError_t (0 on success).
int window_attention_bwd_plan(int dtype, int batch, int height, int width, int channels,
                              int heads, int window, int* plan) {
  if (!takes(channels, heads, window) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{batch, height, width, channels, heads, window, 1, 1.f};
  int out[5];
  const bool wide = warps_of(window * window) == 6;
  const cudaError_t err = dtype == 0 ? (wide ? plan_of<float, 6>(0, g, out)
                                             : plan_of<float, 4>(0, g, out))
                                     : (wide ? plan_of<__nv_bfloat16, 6>(1, g, out)
                                             : plan_of<__nv_bfloat16, 4>(1, g, out));
  std::copy(out, out + 5, plan);
  return static_cast<int>(err);
}

// dtype: 0 float32, 1 bfloat16 (qkv, dout and dqkv); bias and dbias are
// float32 (bias_windows, heads, n, n). Zeroes dbias on the stream, then
// launches. Returns the cudaError_t (0 on success); cudaErrorInvalidValue
// past 96 tokens a window or 64 features a head.
int window_attention_bwd(int dtype, const void* qkv, const float* bias, const void* dout,
                         void* dqkv, float* dbias, int batch, int height, int width, int channels,
                         int heads, int window, int bias_windows, float scale, void* stream) {
  if (!takes(channels, heads, window)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = static_cast<size_t>(window) * window;
  cudaError_t err = cudaMemsetAsync(dbias, 0, bias_windows * heads * n * n * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Geometry g{batch, height, width, channels, heads, window, bias_windows, scale};
  if (dtype == 0) return launch<float>(0, qkv, bias, dout, dqkv, dbias, g, st);
  if (dtype == 1) return launch<__nv_bfloat16>(1, qkv, bias, dout, dqkv, dbias, g, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* window_attention_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
