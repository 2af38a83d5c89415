// What the window-attention kernels share: the forward
// (window_attention_fwd.cu) and the backward (window_attention_bwd.cu) run
// the same unit on the tensor cores, over branch_bwd.cuh's fragments.
//
// The unit: one thread block a (window position, head, group of samples),
// NT warps with the window's n tokens padded to 16 NT (NT = 4 up to 64
// tokens, 6 up to 96: window 9's 81). Warp w owns the queries 16w .. 16w +
// 15. The bias slab of the unit (n x n floats) comes in once, by cp.async;
// then, a sample at a time, q, k, v (and the backward's dO) come in by
// cp.async straight from the (B, H, W, 3C) layout by window addressing,
// token-major, the head dim zero-padded to a multiple of 16 and the tokens
// past n zero. S = (scale q) k^T runs on mma.sync and the softmax works on
// its accumulator fragments: a row's entries sit in one quad of lanes, so
// the max and the sum take two shuffles each, and a row is normalised by
// one reciprocal of its sum. A division an entry would take the IEEE slow
// path on the shift mask's denormal probabilities (K7 ran 1.4 times slower
// shifted in float32, 1.75 times in bfloat16, before one reciprocal a row).
//
// The host side: the number of cp.async stages (one or two samples' buffers)
// and the group's size come from the occupancy the runtime reports, and are
// kept per shape (plan_for): a plan costs a few occupancy queries, and
// ResShift launches the forward 270 times a request at one shape.

#pragma once

#include <algorithm>
#include <array>
#include <map>
#include <mutex>

#include "branch_bwd.cuh"

namespace wattn {

using swin::Route;

constexpr int kMaxTokens = 96;   // ws * ws, both kernels
constexpr int kMaxHeadDim = 64;
constexpr int kMaxHt = kMaxHeadDim / 8;   // n8 tiles of the padded head dim

__host__ __device__ constexpr int warps_of(int n) { return n <= 64 ? 4 : 6; }

struct Geometry {
  int batch, height, width, channels, heads, window;
  int bias_windows;  // leading size of the bias: 1, or the windows of one image
  float scale;
};

inline bool takes(int channels, int heads, int window) {
  return window * window <= kMaxTokens && channels / heads <= kMaxHeadDim;
}

// Word offsets of a unit's buffers; P features of T a word (1 float32, 2
// bfloat16). A stage holds one sample's `parts` head buffers: q, k, v (and
// the backward's dO).
struct Layout {
  int ldB, ldH, ldP;   // pitches: the bias (floats), the head buffers (words), P (words)
  int bias, stage, ps, tokens, words;   // offsets
};

__host__ __device__ inline Layout layout_of(int parts, int channels, int heads, int window,
                                            int P, int stages) {
  const int n = window * window, np = 16 * warps_of(n), hdp = swin::round_up16(channels / heads);
  Layout l;
  l.ldB = np + 8;   // float2 reads of a quad's rows hit distinct banks
  l.ldH = swin::pitch(hdp / P);
  l.ldP = swin::pitch(np / P);
  l.bias = 0;
  l.stage = l.bias + n * l.ldB;   // the slab's n rows: 81 at window 9 saves 6 KB
  l.ps = l.stage + stages * parts * np * l.ldH;
  l.tokens = l.ps + np * l.ldP;
  l.words = l.tokens + np;
  return l;
}

inline size_t smem_bytes(int parts, int dtype, int channels, int heads, int window,
                         int stages) {
  return static_cast<size_t>(
             layout_of(parts, channels, heads, window, dtype + 1, stages).words) * 4;
}

// ------------------------------------------------------------------ the unit
struct Unit {
  int h, win, first, last;   // head, window of the image, the group's samples [first, last)
  size_t slab;               // offset of the unit's n x n bias slab
};

__device__ __forceinline__ Unit unit_of(const Geometry& g, int samples_per_unit) {
  const int nw = (g.height / g.window) * (g.width / g.window), n = g.window * g.window;
  const int position = blockIdx.x % (nw * g.heads);
  Unit u;
  u.h = position % g.heads;
  u.win = position / g.heads;
  u.first = blockIdx.x / (nw * g.heads) * samples_per_unit;
  u.last = min(g.batch, u.first + samples_per_unit);
  u.slab = (static_cast<size_t>(g.bias_windows == 1 ? 0 : u.win) * g.heads + u.h) * n * n;
  return u;
}

// at[t] = token t's row * W + column in the image (0 past n), and the unit's
// bias slab, rows of n floats at pitch ldB, by cp.async (not committed)
template <int kThreads>
__device__ __forceinline__ void unit_start(int* at, uint32_t* dst, int ldB, const float* src,
                                           const Geometry& g, int win, int np) {
  const int ws = g.window, n = ws * ws, nww = g.width / ws;
  for (int t = threadIdx.x; t < np; t += kThreads)
    at[t] = t < n ? ((win / nww) * ws + t / ws) * g.width + (win % nww) * ws + t % ws : 0;
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

// Words a cp.async of a head's row may take: 4 where every row start allows
// 16 bytes, else 2 or 1; 0 for bfloat16 with an odd head dim
template <int P>
__device__ __forceinline__ int copy_words(int C, int hd) {
  return (C % (4 * P) == 0 && hd % (4 * P) == 0)   ? 4
         : (C % (2 * P) == 0 && hd % (2 * P) == 0) ? 2
         : (hd % P == 0)                           ? 1
                                                   : 0;
}

// The kParts buffers of sample img (rows of np tokens, pitch ldH words): q,
// k, v of head h from qkv (B, H, W, 3C), and a fourth, the backward's dO,
// from dout (B, H, W, C); zero past hd and past n. cp.async of kc words
// (copy_words), not committed.
template <typename T, int kParts, int kThreads>
__device__ __forceinline__ void load_sample(uint32_t* const (&dst)[kParts], const T* qkv,
                                            const T* dout, const int* at, const Geometry& g,
                                            int img, int h, int np, int ldH, int kc) {
  constexpr int P = 4 / sizeof(T);
  const int C = g.channels, n = g.window * g.window, hd = C / g.heads;
  const int Hw = swin::round_up16(hd) / P;
  auto token = [&](int t, int ch) {
    return (static_cast<size_t>(img) * g.height * g.width + at[t]) * ch;
  };
  if (kc == 0) {   // bfloat16 with an odd head dim: element by element
    for (int e = threadIdx.x; e < kParts * np * Hw * P; e += kThreads) {
      const int part = e / (np * Hw * P), r = e % (np * Hw * P), t = r / (Hw * P),
                d = r % (Hw * P);
      float v = 0.f;
      if (t < n && d < hd)
        v = swin::to_f32(part < 3 ? qkv[token(t, 3 * C) + part * C + h * hd + d]
                                  : dout[token(t, C) + h * hd + d]);
      reinterpret_cast<T*>(dst[part])[t * ldH * P + d] = swin::from_f32<T>(v);
    }
    return;
  }
  const int per_row = Hw / kc, valid = hd / P;
  for (int e = threadIdx.x; e < kParts * np * per_row; e += kThreads) {
    const int part = e / (np * per_row), r = e % (np * per_row), t = r / per_row,
              q = (r % per_row) * kc;
    const bool ok = t < n && q < valid;
    const T* src = part < 3 ? qkv + (ok ? token(t, 3 * C) + part * C + h * hd : 0)
                            : dout + (ok ? token(t, C) + h * hd : 0);
    uint32_t* d = dst[part] + t * ldH + q;
    const void* s = reinterpret_cast<const uint32_t*>(src) + (ok ? q : 0);
    if (kc == 4)
      swin::cp_async_zfill<4>(d, s, ok);
    else if (kc == 2)
      swin::cp_async_zfill<2>(d, s, ok);
    else
      swin::cp_async_zfill<1>(d, s, ok);
  }
}

// q * scale, rounded to T, in place: this warp's 16 rows (S reads only them)
template <int P>
__device__ __forceinline__ void scale_rows(uint32_t* q, int ldH, int m0, int Hw, float scale) {
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < 16 * Hw; e += 32) {
    uint32_t* w = q + (m0 + e / Hw) * ldH + e % Hw;
    if constexpr (P == 1) {
      *w = __float_as_uint(__uint_as_float(*w) * scale);
    } else {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w));
      *w = swin::pack_bf16(f.x * scale, f.y * scale);
    }
  }
  __syncwarp();
}

// acc(m, j) = sum_d A[m0 + m][d] B[j][d] for this warp's 16 rows m and the
// J n8 tiles of keys j: S (A = scale q, B = k) and the backward's dP (A =
// dO, B = v), K = the Hw words of the padded head dim, both token-major
template <Route R, int J>
__device__ __forceinline__ void score_product(float (&acc)[J][4], const uint32_t* A,
                                              const uint32_t* B, int ld, int m0, int Hw) {
#pragma unroll 1
  for (int kw = 0; kw < Hw; kw += 8) {
    uint32_t a[4], al[4], b[2];
    swin::frag_a(a, A, ld, m0, kw);
    swin::split_a<R>(a, al);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      swin::frag_b(b, B, ld, 8 * j, kw);
      swin::mma3<R>(acc[j], a, al, b[0], b[1]);
    }
  }
}

// P = softmax(S + bias) over the n keys, in this warp's fragments of S (rows
// m0 ..): keys past n drop out (-inf before the max), a padded query's row
// is zero; float32, one reciprocal a row
template <int J>
__device__ __forceinline__ void softmax_fragments(float (&p)[J][4], const float* Bs, int ldB,
                                                  int m0, int n) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = m0 + gq + 8 * i, key = 8 * j + 2 * tq;
      const float2 bv = *reinterpret_cast<const float2*>(Bs + min(q, n - 1) * ldB + key);
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
  for (int j = 0; j < J; ++j)
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
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) p[j][r] *= sum[r >> 1];
}

// this warp's rows of a J n8-tile fragment matrix into Ps (rows of queries,
// pitch ldP words), rounded to T
template <typename T, int J>
__device__ __forceinline__ void store_rows(uint32_t* Ps, int ldP, const float (&p)[J][4], int m0) {
#pragma unroll
  for (int j = 0; j < J; ++j)
    swin::tile_pairs(p[j], m0, 8 * j, [&](int q, int key, float v0, float v1) {
      swin::set2<T>(Ps, ldP, q, key, swin::round_to<T>(v0), swin::round_to<T>(v1));
    });
}

// ------------------------------------------------------------------ the plan
// The plans by kernel, shape and device, and the dynamic shared memory each
// kernel was allowed on each device: one table a library (static, not
// inline: an inline function's static would be one object for every library
// the process loads).
struct Plans {
  std::mutex lock;
  std::map<std::pair<const void*, std::array<int, 9>>, std::array<int, 5>> by_shape;
  std::map<std::pair<const void*, int>, size_t> allowed;
};

static Plans& plans() {
  static Plans p;
  return p;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory on the current
// device, raising its limit only: a plan kept from an earlier shape may
// launch it with more. The caller holds the lock.
template <class K>
cudaError_t allow(K kernel, size_t smem, int device) {
  size_t& now = plans().allowed[{reinterpret_cast<const void*>(kernel), device}];
  if (smem <= now) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) now = smem;
  return err;
}

// The plan {units, samples a unit, blocks an SM, SMs, stages} of a kernel
// whose block takes smem1 / smem2 bytes with one / two stages: two stages
// unless one lets an SM hold more blocks (the products of a block are a
// chain of dependent latencies, so more blocks an SM hide more of them than
// the early copy does); and units = window positions x heads x groups of
// samples, the group the one that minimises waves x (samples a unit + 1),
// the time of the last wave's slowest block with a unit's own work (its bias
// slab; the backward's dbias adds) counted as one sample more; the largest of
// those. Kept per shape and device after its first call.
template <class K>
cudaError_t plan_for(K kernel, int dtype, int threads, size_t smem1, size_t smem2,
                     const Geometry& g, int (&plan)[5]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::pair<const void*, std::array<int, 9>> key{
      reinterpret_cast<const void*>(kernel),
      {dtype, g.batch, g.height, g.width, g.channels, g.heads, g.window, threads, device}};
  std::lock_guard<std::mutex> guard(plans().lock);
  const auto kept = plans().by_shape.find(key);
  if (kept != plans().by_shape.end()) {
    std::copy(kept->second.begin(), kept->second.end(), plan);
    return cudaSuccess;
  }
  int per[3] = {0, 0, 0}, sms = 0;
  for (int s = 1; s <= 2; ++s) {
    const size_t smem = s == 1 ? smem1 : smem2;
    if (smem > static_cast<size_t>(swin::kSmemLimit)) continue;
    err = allow(kernel, smem, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per[s], kernel, threads, smem);
    if (err != cudaSuccess) return err;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int stages = per[1] > per[2] ? 1 : 2, per_sm = per[stages];
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
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
  std::copy(plan, plan + 5, plans().by_shape[key].begin());
  return cudaSuccess;
}

}  // namespace wattn
