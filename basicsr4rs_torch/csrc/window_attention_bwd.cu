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
// The unit is the forward's (window_attention.cuh: a block a (window
// position, head, group of samples), a warp 16 queries, the softmax on S's
// fragments with one reciprocal a row), with dO as a fourth buffer a sample.
// Warp w owns the rows 16w .. of S, P, dP and dS, and of dV, dQ and dK.
// - Operands: q, k, v and dO sit token-major in shared memory. S and dP (K =
//   the head dim) read the words as they are; dV, dQ and dK (K = the tokens)
//   read P, dS, dO, k and q transposed: by index in float32, by
//   ldmatrix.trans in bfloat16. No second copy is kept.
// - rowsum(dP * P) works on the accumulator fragments, as the softmax does:
//   P and dP never leave registers for it. P (rounded to T) goes to shared
//   memory once, for dV; dS replaces it in place for dQ and dK.
// - dbias sums dS over the group's samples in registers and leaves the block
//   once, by float4 vector reductions where a row of n floats keeps 16-byte
//   alignment (n % 4 == 0) and scalar atomicAdd otherwise; the order of those
//   adds, hence dbias's last bits, changes from run to run. The plan counts
//   a unit's own work (its bias slab, its dbias adds) as one sample more:
//   without that term window 9's 72x72 maps ran a sample a unit, 6144 units
//   reloading their slabs and adding 6561 scalar atomics each, 1.25 times as
//   slow. Float32 at 64 tokens runs three blocks of one stage an SM rather
//   than two of two: the products of a block are a chain of dependent
//   latencies, so more blocks an SM hide more of them than the early copy.
// - dqkv is written once, from the accumulators into its place in (B, H, W,
//   3C), by window addressing: no partition copy.

#include "window_attention.cuh"

namespace {

using swin::Route;
using swin::frag_a;
using swin::frag_a_t;
using swin::frag_b_t;
using swin::mma3;
using swin::round_up16;
using swin::split_a;
using wattn::Geometry;
using wattn::kMaxHt;
using wattn::warps_of;

constexpr int kParts = 4;   // head buffers a stage: q, k, v, dO

size_t smem_bytes(int dtype, int channels, int heads, int window, int stages) {
  return wattn::smem_bytes(kParts, dtype, channels, heads, window, stages);
}

// The four buffers of one sample: q (scaled in place), k, v, dO
struct Stage {
  uint32_t* q;
  uint32_t* k;
  uint32_t* v;
  uint32_t* dout;
};

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
  const wattn::Layout L = wattn::layout_of(kParts, C, g.heads, ws, P, stages);
  const int ldB = L.ldB, ldH = L.ldH, ldP = L.ldP;
  const wattn::Unit u = wattn::unit_of(g, samples_per_unit);
  const int h = u.h, first = u.first, last = u.last;
  const float scale = g.scale;
  const int m0 = 16 * (threadIdx.x >> 5);

  const float* Bs = reinterpret_cast<const float*>(smem + L.bias);
  uint32_t* Ps = smem + L.ps;   // P, then dS: rows of queries
  int* at = reinterpret_cast<int*>(smem + L.tokens);   // token t's (row, column) in the image
  auto stage = [&](int s) {
    uint32_t* b = smem + L.stage + s * kParts * kNp * ldH;
    return Stage{b, b + kNp * ldH, b + 2 * kNp * ldH, b + 3 * kNp * ldH};
  };
  wattn::unit_start<kThreads>(at, smem + L.bias, ldB, bias + u.slab, g, u.win, kNp);
  __syncthreads();   // the token table

  // element offset of token t of sample img in a (B, H, W, ch) tensor
  auto token = [&](int img, int t, int ch) {
    return (static_cast<size_t>(img) * g.height * g.width + at[t]) * ch;
  };
  // q, k, v, dO of sample img into a stage
  const int kc = wattn::copy_words<P>(C, hd);
  auto load = [&](int img, const Stage& st) {
    uint32_t* const dst[kParts] = {st.q, st.k, st.v, st.dout};
    wattn::load_sample<T, kParts, kThreads>(dst, qkv, dout, at, g, img, h, kNp, ldH, kc);
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
    wattn::scale_rows<P>(st.q, ldH, m0, Hw, scale);

    // S = (scale q) k^T + bias, and P = softmax(S), in this warp's fragments
    float p[kJt][4] = {};
    wattn::score_product<R, kJt>(p, st.q, st.k, ldH, m0, Hw);
    wattn::softmax_fragments(p, Bs, ldB, m0, n);
    wattn::store_rows<T>(Ps, ldP, p, m0);

    // dP = dO v^T; delta = rowsum(dP * P); dS = P (dP - delta), into dbias
    float dp[kJt][4] = {};
    wattn::score_product<R, kJt>(dp, st.dout, st.v, ldH, m0, Hw);
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
    wattn::store_rows<T>(Ps, ldP, dp, m0);
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

  float* out = dbias + u.slab;
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

template <typename T, int NT>
int plan_of(int dtype, const Geometry& g, int (&plan)[5]) {
  return static_cast<int>(wattn::plan_for(
      window_attention_bwd_kernel<T, NT>, dtype, 32 * NT,
      smem_bytes(dtype, g.channels, g.heads, g.window, 1),
      smem_bytes(dtype, g.channels, g.heads, g.window, 2), g, plan));
}

template <typename T, int NT>
int launch(int dtype, const void* qkv, const float* bias, const void* dout, void* dqkv,
           float* dbias, const Geometry& g, cudaStream_t stream) {
  int plan[5];
  const int err = plan_of<T, NT>(dtype, g, plan);
  if (err != 0) return err;
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
  if (!wattn::takes(channels, heads, window) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{batch, height, width, channels, heads, window, 1, 1.f};
  int out[5];
  const bool wide = warps_of(window * window) == 6;
  const int err = dtype == 0 ? (wide ? plan_of<float, 6>(0, g, out)
                                             : plan_of<float, 4>(0, g, out))
                                     : (wide ? plan_of<__nv_bfloat16, 6>(1, g, out)
                                             : plan_of<__nv_bfloat16, 4>(1, g, out));
  std::copy(out, out + 5, plan);
  return err;
}

// dtype: 0 float32, 1 bfloat16 (qkv, dout and dqkv); bias and dbias are
// float32 (bias_windows, heads, n, n). Zeroes dbias on the stream, then
// launches. Returns the cudaError_t (0 on success); cudaErrorInvalidValue
// past 96 tokens a window or 64 features a head.
int window_attention_bwd(int dtype, const void* qkv, const float* bias, const void* dout,
                         void* dqkv, float* dbias, int batch, int height, int width, int channels,
                         int heads, int window, int bias_windows, float scale, void* stream) {
  if (!wattn::takes(channels, heads, window)) return static_cast<int>(cudaErrorInvalidValue);
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
