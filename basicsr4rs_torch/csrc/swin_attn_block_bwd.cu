// Swin attention branch, backward (K3), every product on the tensor cores.
//
// Replaces basicsr4rs_tpu/ops/swin_block.py::_block_bwd_kernel. From x and
// the cotangent dz alone it recomputes LN(x), q/k/v and the attention
// probabilities and emits
//
//   dx, d ln_w, d ln_b, d Wqkv, d bqkv, d Wproj, d bproj, d rel_bias
//
// of  out = z,  z + x  or  s[b] * z + x  with z = proj(W-MSA(LN(x))). The
// branch cotangent is s[b] * dz, the residual cotangent dz itself. The
// relative-position bias (heads, n, n) is shared by every window, so its
// gradient is the sum of the score cotangents over all windows and samples;
// the shift mask gets none.
//
// Bound on an H100: operations. 22 C^2 + 12 n C FLOP a token (7.84 GFLOP at
// B=4 48x48, C=180, 6 heads of 30, window 8): 0.0475 ms as 3xTF32 at 495
// TFLOP/s in float32, 0.0079 ms in bfloat16 at 989 (0.117 ms on the CUDA
// cores, this kernel's first route).
//
// What held the first route back, and what this design does about it:
// 1. Every product ran on the CUDA cores. Now each is an mma.sync
//    (tensor_core.cuh): 3xTF32 m16n8k8 in float32 (plain TF32's 2^-11 would
//    leave the float32 tolerance), m16n8k16 in bfloat16, float32 sums. The
//    products of one window and head (head dim hd padded to hdp, a multiple
//    of 16, with zero features):
//      q, k, v = LN(x) Wqkv[head]^T   64 x 3hdp x C   (rows of 96 at a time)
//      S = q k^T                      64 x 64 x hdp
//      O = P v                        64 x hdp x 64
//      dO = dz Wproj[:, head]         64 x hdp x C
//      dWproj[:, head] += dz^T O      C x hdp x 64 tokens
//      dV = P^T dO                    64 x hdp x 64
//      dP = dO v^T                    64 x 64 x hdp
//      dQ = scale dS k, dK = dS^T q   64 x hdp x 64
//      dL/dLN(x) += dqkv Wqkv[head]   64 x C x 3hdp
//      dWqkv[head] += dqkv^T LN(x)    3hdp x C x 64 tokens
//    Every activation sits token-major in shared memory (a row of T a
//    token, pitch = 4 mod 8 words: the fragments' word loads and ldmatrix's
//    rows hit distinct banks). A product whose K is the features reads its
//    words as they are; one whose K is the tokens (or the keys) reads the
//    same buffer transposed: in float32 a word is one value, so only the
//    index changes (two lanes share a bank), in bfloat16 through
//    ldmatrix.trans, which packs two tokens of a feature into a word. Wqkv's
//    rows are read directly for q, k, v and transposed for dL/dLN(x); Wproj's
//    head columns transposed for dO. The float32 split into hi and lo
//    truncates (split_fast): cvt.rna's two conversions a word cost more than
//    the three products they feed.
// 2. A tail wave: the first route ran a window a block (224 KB of shared
//    memory, one block an SM): 144 windows on 132 SMs in two waves, 55%
//    filled. Now a block takes one (window, head) unit and the head's
//    partial dL/dLN(x) goes into a zeroed float32 (tokens, C) buffer; a
//    second launch (branch_ln_bwd_kernel, branch_bwd.cuh) runs the LayerNorm
//    backward, dx (+ dz), d ln_w, d ln_b and d bproj from x, dz and that
//    buffer (about 26 MB of traffic). 864 units at 193 KB (float32, C=180;
//    142 KB in bfloat16) run one block an SM: 6.55 waves of 132, the last
//    one 72 blocks, so the units fill 864 / (7 x 132) = 93.5% of the SMs
//    over the kernel's time. Of the two designs that reach 80%, this one
//    needs no cluster: splitting a window's heads over a cluster of 2 or 3
//    blocks keeps dL/dLN(x) (46 KB) and LN(x) resident in each block, and
//    fills 73% or 82%.
// 3. A scalar atomicAdd for every weight-gradient element of every window
//    (22 M a call). Now the weight gradients are tensor-core products over
//    the window's tokens whose tiles leave the block once, as Hopper's
//    vector reductions: atomicAdd of a float4 (dWqkv, dL/dLN(x), d rel_bias;
//    two lanes' pairs joined by a shuffle) or a float2 (dWproj, whose head
//    columns start at h hd, 8-byte aligned). d rel_bias falls back to scalar
//    adds when n % 4 != 0 (odd windows). d bqkv (3 hd a unit) stays scalar.
//    The sums' order changes from run to run.
// 4. The weight stream: Wqkv[head] twice and Wproj[:, head] once a unit
//    (161 KB in float32), through three shared-memory stages of 64 words of
//    K (32 for dL/dLN(x), or where 64 would not fit) by cp.async, two in
//    flight while one is read, the first two of each product issued ahead
//    of the work before it. x, dz and x again come in by cp.async too, and
//    LayerNorm and the scaling run over them in place.
// 5. Ten barriers a head over six heads; now about twenty a unit, and a
//    unit is one head.
// LN(x), the branch cotangent and LN(x) again (recomputed from x and the
// saved statistics) share one C-row buffer; q, k, v, O, dO hold dv, dq,
// dk in turn; P holds dS. So C <= 256 and head dims <= 96 fit in 229 KB,
// every shape the first route took.
//
// What holds it back still (ops/joint_block_clock.py --kernel attn_bwd,
// block 0 at B=4 48x48, float32, on an NVIDIA H100 80GB HBM3 at 700 W): a
// unit takes about 125k cycles, 9 times its share of the 3xTF32 bound; the
// weight products' steps are 39% of it, the end (dL/dLN(x)'s vector
// reductions and dWqkv) 16%, the first copy of x 7%. bfloat16 takes 0.7
// of float32's time: most of a unit is not the multiplications but the
// issue of loads, splits and address arithmetic of small tiles (16 x 8 to
// 16 x 24 a warp, 16 warps, one unit an SM) and the barriers between
// twenty dependent phases. Loops are rolled and copies
// free of divisions where they run once a unit: such straight-line code is
// fetched from L2 as it runs. What is left to try: two units an SM
// (8 warps each, weights read from L2 without stages, so that one unit's
// barriers overlap the other's products), or two heads a unit in bfloat16.
//
// Roundings (bfloat16): LN(x), q, k, v (q after its scale, as the mma takes
// it), P, O, s * dz, dO, dS (after its use in d rel_bias) and dq, dk, dv
// are rounded to the model dtype; every sum, the softmax and the LayerNorm
// backward stay float32.

#include "branch_bwd.cuh"

namespace {

using namespace swin;

struct Params {
  const void* x;
  const void* dz;
  void* dx;
  int batch, height, width, channels, heads, window;
  const float* ln_w;
  const float* ln_b;
  const void* wqkv;  // (3C, C)
  const float* bqkv;
  const void* wproj;  // (C, C)
  const float* rel_bias;  // (heads, n, n)
  const float* mask;      // (nW, n, n) or null
  int mode;
  const float* s;  // (B,) when mode == kScaled
  float scale;
  // float32 gradients, zeroed before the launch
  float* dln_w;
  float* dln_b;
  float* dwqkv;
  float* dbqkv;
  float* dwproj;
  float* dbproj;
  float* drel_bias;
  float* dln;  // (tokens, C) float32 scratch, zeroed: dL/d LN(x) summed over the heads
};

constexpr int kMaxHeadPadded = 96;   // padded head dim: dO's outputs, 3 n8 tiles a warp
constexpr int kQkvRows = 96;      // rows of q|k|v a product computes: 3 n8 tiles a warp

// Word offsets of the buffers; P features of the model dtype a word.
struct BwdLayout {
  int ldR, ldH, ldP;           // pitches: C features, hdp features, 64 keys
  int q, k, v, o, dout, p;     // R (LN(x) / s dz / LN(x)) at 0
  int kq;                      // words of K a stage of q, k, v or dO holds
  int stages, stage_words, red, stats, tables, words;
};

__host__ __device__ inline BwdLayout bwd_layout(int channels, int heads, int P) {
  const int hdp = round_up16(channels / heads);
  BwdLayout l;
  l.ldR = pitch(channels / P);
  l.ldH = pitch(hdp / P);
  l.ldP = pitch(kTok / P);
  l.q = kTok * l.ldR;
  l.k = l.q + kTok * l.ldH;
  l.v = l.k + kTok * l.ldH;
  l.o = l.v + kTok * l.ldH;
  l.dout = l.o + kTok * l.ldH;
  l.p = l.dout + kTok * l.ldH;
  l.stages = l.p + kTok * l.ldP;
  // a stage: 96 weight rows of kq words (q, k, v), kq words of K as rows of
  // hdp features (dO), or kKw as rows of C features (dL/dLN(x))
  for (l.kq = 2 * kKw;; l.kq = kKw) {
    l.stage_words = imax(imax(kQkvRows * (l.kq + 4), l.kq * P * l.ldH), kKw * P * l.ldR);
    l.red = l.stages + kStages * l.stage_words;
    l.stats = l.red + kRed;   // mean, 1 / std and delta of each token
    l.tables = l.stats + 3 * kTok;   // each token's index, each padded qkv row's Wqkv row
    l.words = l.tables + kTok + 3 * hdp;
    if (l.words * 4 <= kSmemLimit || l.kq == kKw) return l;
  }
}

size_t bwd_smem_bytes(int dtype, int channels, int heads) {
  return static_cast<size_t>(bwd_layout(channels, heads, dtype + 1).words) * 4;
}

// ------------------------------------------------------------------ the unit
// One thread block for head h of one window.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) swin_attn_block_bwd_kernel(const Params p) {
  constexpr Route R = sizeof(T) == 4 ? kTF32x3 : kBF16;
  constexpr int P = 4 / sizeof(T);   // features of T a word
  constexpr int kCopyRow = P == 1 ? 4 : 2;   // words a copy of a weight row (C % 4 == 0)
  constexpr int kCopyCol = P == 1 ? 2 : 1;   // of Wproj's head columns (from h hd, hd even)
  extern __shared__ __align__(16) uint32_t smem[];

  const int H = p.height, W = p.width, C = p.channels, heads = p.heads;
  const int ws = p.window, n = ws * ws, hd = C / heads, hdp = round_up16(hd);
  const int h = blockIdx.x % heads, unit_window = blockIdx.x / heads;
  const int nww = W / ws, nw = (H / ws) * nww;
  const int img = unit_window / nw, win = unit_window % nw;
  const int row0 = (win / nww) * ws, col0 = (win % nww) * ws;
  const float* mask = p.mask ? p.mask + static_cast<size_t>(win) * n * n : nullptr;
  const float s = p.mode == kScaled ? p.s[img] : 1.f;
  const float scale = p.scale;
  const T* x = static_cast<const T*>(p.x);
  const T* dz = static_cast<const T*>(p.dz);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3, m0 = (warp & 3) * 16, wn = warp >> 2;

  const BwdLayout L = bwd_layout(C, heads, P);
  const int ldR = L.ldR, ldH = L.ldH, ldP = L.ldP, kq = L.kq;
  uint32_t* Rb = smem;              // LN(x); s dz; LN(x) again
  uint32_t* Qb = smem + L.q;        // q (scaled)
  uint32_t* Kb = smem + L.k;        // k
  uint32_t* Vb = smem + L.v;        // v, then dk
  uint32_t* Ob = smem + L.o;        // the head's attention output, then dv
  uint32_t* Db = smem + L.dout;     // dO, then dq
  uint32_t* Pb = smem + L.p;        // P, then dS, rows of queries
  uint32_t* stages = smem + L.stages;
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* mu = reinterpret_cast<float*>(smem + L.stats);
  float* inv_std = mu + kTok;
  float* delta = inv_std + kTok;
  int* tok_at = reinterpret_cast<int*>(smem + L.tables);   // token t's index in x
  int* wrow = tok_at + kTok;   // padded row r of q|k|v: its Wqkv row, or -1
  const int Cw = C / P, Hw = hdp / P, Kp = kTok / P;   // words of C, hdp and 64 keys
  const int Cpad = (Cw + 7) / 8 * 8 * P;   // features a product reads: zero past C

  // token t of the window sits at row row0 + t / ws, column col0 + t % ws
  for (int t = threadIdx.x; t < kTok; t += kThreads)
    tok_at[t] = t < n ? (img * H + row0 + t / ws) * W + col0 + t % ws : 0;
  for (int r = threadIdx.x; r < 3 * hdp; r += kThreads) {
    const int part = r / hdp, d = r - part * hdp;
    wrow[r] = d < hd ? part * C + h * hd + d : -1;
  }
  __syncthreads();
  auto token = [&](int t) { return static_cast<size_t>(tok_at[t]); };
  auto part_of = [&](int r) { return r >= 2 * hdp ? 2 : r >= hdp ? 1 : 0; };
  auto words_of = [](const void* w, size_t element) {
    return reinterpret_cast<const uint32_t*>(static_cast<const T*>(w) + element);
  };
  // row r of q|k|v (padded): Wqkv row part * C + h hd + d, or none
  auto qkv_row = [&](int r) -> const uint32_t* {
    return r < 3 * hdp && wrow[r] >= 0 ? words_of(p.wqkv, static_cast<size_t>(wrow[r]) * C)
                                       : nullptr;
  };
  auto qkv_in = [&](int chunk) {   // the stages of q|k|v rows 96 chunk ..
    return [&, chunk](int step) {
      if (step * kq < Cw) {
        const int kw0 = step * kq, kn = (min(kq, Cw - kw0) + 7) & ~7;
        stage_in<kCopyRow>(stages + (step % kStages) * L.stage_words, kq + 4,
                           min(kQkvRows, 3 * hdp - kQkvRows * chunk), kn, Cw - kw0,
                           [&, chunk, kw0](int r) -> const uint32_t* {
                             const uint32_t* row = qkv_row(kQkvRows * chunk + r);
                             return row != nullptr ? row + kw0 : nullptr;
                           },
                           p.x);
      } else {
        cp_async_commit();
      }
    };
  };
  const auto proj_in = [&](int step) {   // rows o of Wproj[:, head], hdp columns
    if (step * kq < Cw) {
      const int o0 = step * kq * P;
      stage_in<kCopyCol>(stages + (step % kStages) * L.stage_words, ldH, kq * P, Hw, hd / P,
                         [&, o0](int r) -> const uint32_t* {
                           const int o = o0 + r;
                           return o < C ? words_of(p.wproj, static_cast<size_t>(o) * C + h * hd)
                                        : nullptr;
                         },
                         p.x);
    } else {
      cp_async_commit();
    }
  };
  const auto qkvt_in = [&](int step) {   // rows r of Wqkv[head], C columns
    if (step * kKw < 3 * Hw) {
      const int r0 = step * kKw * P;
      stage_in<kCopyRow>(stages + (step % kStages) * L.stage_words, ldR, kKw * P, Cw, Cw,
                         [&, r0](int r) { return qkv_row(r0 + r); }, p.x);
    } else {
      cp_async_commit();
    }
  };
  // dq | dk | dv, token-major, by word of the padded rows
  auto dqkv_a = [&](uint32_t (&a)[4], int m, int kw) {
    const int part = kw >= 2 * Hw ? 2 : kw >= Hw ? 1 : 0;
    frag_a(a, part == 0 ? Db : part == 1 ? Vb : Ob, ldH, m, kw - part * Hw);
  };

  // a product's first two stages, issued ahead of the work before it
  auto prefetch = [](auto in) {
    in(0);
    in(1);
  };
  prefetch(qkv_in(0));

  // cp.async of the n tokens' rows of src into R, zero for the tokens >= n
  // and the features from C to Cpad; one commit group
  auto rows_in = [&](const T* src) {
    stage_in<kCopyRow>(Rb, ldR, kTok, Cpad / P, Cw, [&](int t) -> const uint32_t* {
      return t < n ? words_of(src, token(t) * C) : nullptr;
    }, p.x);
  };
  // LN(x) in place of the rows of x in R, a warp a token; keep: compute the
  // statistics and keep them, else use those kept. Rolled loops: this runs
  // once a unit, and straight-line code is fetched from L2 as it runs.
  auto layer_norm_rows = [&](bool keep) {
    for (int t = warp; t < n; t += kWarps) {
      float mean, inv;
      if (keep) {
        float sum = 0.f, ss = 0.f;
        for (int c = lane; c < C; c += 32) {
          const float v = get1<T>(Rb, ldR, t, c);
          sum += v;
          ss += v * v;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
          ss += __shfl_xor_sync(0xffffffffu, ss, o);
        }
        mean = sum / C;
        inv = rsqrtf(ss / C - mean * mean + 1e-5f);
        if (lane == 0) {
          mu[t] = mean;
          inv_std[t] = inv;
        }
      } else {
        mean = mu[t];
        inv = inv_std[t];
      }
      for (int c = lane; c < C; c += 32)
        set1<T>(Rb, ldR, t, c,
                round_to<T>((get1<T>(Rb, ldR, t, c) - mean) * inv * p.ln_w[c] + p.ln_b[c]));
    }
  };
  rows_in(x);
  cp_async_wait<0>();
  __syncthreads();
  layer_norm_rows(true);

  // q (scaled), k, v of head h, 96 rows of q|k|v at a time
  for (int chunk = 0; chunk * kQkvRows < 3 * hdp; ++chunk) {
    float acc[3][4] = {};
    streamed_product<R, T, 3, false>(acc, Cw, kq, min(kQkvRows, 3 * hdp - kQkvRows * chunk),
                                     kq + 4, stages, L.stage_words, qkv_in(chunk),
                                     [&](uint32_t (&a)[4], int m, int kw) {
                                       frag_a(a, Rb, ldR, m, kw);
                                     });
    if ((chunk + 1) * kQkvRows < 3 * hdp) {
      prefetch(qkv_in(chunk + 1));
    } else {   // R is free: the cotangent's rows, then dO's first stages
      rows_in(dz);
      prefetch(proj_in);
    }
#pragma unroll
    for (int jj = 0; jj < 3; ++jj) {
      const int o0 = 8 * (wn + 4 * jj);
      if (kQkvRows * chunk + o0 >= 3 * hdp || o0 >= kQkvRows) break;
      tile_pairs(acc[jj], m0, o0, [&](int m, int o, float v0, float v1) {
        const int r = kQkvRows * chunk + o, part = part_of(r), d = r - part * hdp;
        float f0 = 0.f, f1 = 0.f;   // zero in the padded features and tokens
        if (wrow[r] >= 0 && m < n) {
          const float* b = p.bqkv + wrow[r];
          f0 = round_to<T>(v0 + b[0]);
          f1 = round_to<T>(v1 + b[1]);
          if (part == 0) {
            f0 = round_to<T>(f0 * scale);
            f1 = round_to<T>(f1 * scale);
          }
        }
        set2<T>(part == 0 ? Qb : part == 1 ? Kb : Vb, ldH, m, d, f0, f1);
      });
    }
  }
  __syncthreads();

  {  // probabilities: this warp's 16 queries by keys 16 wn .. 16 wn + 15
    const float* bias = p.rel_bias + static_cast<size_t>(h) * n * n;
    float sc[2][4];
#pragma unroll
    for (int jt = 0; jt < 2; ++jt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int q = m0 + g + 8 * (r >> 1), key = 16 * wn + 8 * jt + 2 * tq + (r & 1);
        sc[jt][r] = key >= n ? -INFINITY
                    : q < n  ? bias[q * n + key] + (mask ? mask[q * n + key] : 0.f)
                             : 0.f;
      }
    float qk[2][2][4] = {};   // even and odd k-steps
#pragma unroll 4
    for (int kw = 0; kw < Hw; kw += 8) {
      uint32_t a[4], al[4], b[2];
      frag_a(a, Qb, ldH, m0, kw);
      split_a<R>(a, al);
#pragma unroll
      for (int jt = 0; jt < 2; ++jt) {
        frag_b(b, Kb, ldH, 16 * wn + 8 * jt, kw);
        mma3<R>(qk[(kw >> 3) & 1][jt], a, al, b[0], b[1]);
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
      if (tq == 0) rmax[wn * kTok + m0 + g + 8 * i] = mx[i];
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
      if (tq == 0) rsum[wn * kTok + m0 + g + 8 * i] = sum[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = m0 + g + 8 * i;
      sum[i] = q < n ? rsum[q] + rsum[kTok + q] + rsum[2 * kTok + q] + rsum[3 * kTok + q]
                     : INFINITY;   // a padded query's row is zero
    }
#pragma unroll
    for (int jt = 0; jt < 2; ++jt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        set2<T>(Pb, ldP, m0 + g + 8 * i, 16 * wn + 8 * jt + 2 * tq,
                round_to<T>(sc[jt][2 * i] / sum[i]), round_to<T>(sc[jt][2 * i + 1] / sum[i]));
  }
  __syncthreads();
  // O = P v
  smem_product<R, 1>(
      kTok, hdp, Kp, [&](uint32_t (&a)[4], int m, int kw) { frag_a(a, Pb, ldP, m, kw); },
      [&](uint32_t (&b)[2], int n0, int kw) { frag_b_t<T>(b, Vb, ldH, n0, kw); },
      [&](int mt, int nt, const float (&c)[4]) {
        tile_pairs(c, mt, nt, [&](int m, int d, float v0, float v1) {
          set2<T>(Ob, ldH, m, d, round_to<T>(v0), round_to<T>(v1));
        });
      });
  // s dz in R, rounded (LN(x) is recomputed at the end)
  cp_async_wait<2>();   // the rows of dz, ahead of dO's two stages
  __syncthreads();
  if (s != 1.f)
    for (int t = warp; t < n; t += kWarps)
      for (int c = lane; c < C; c += 32)
        set1<T>(Rb, ldR, t, c, round_to<T>(s * get1<T>(Rb, ldR, t, c)));
  // dO = s dz Wproj[:, head] (its first stages are in flight since q, k, v)
  {
    float acc[3][4] = {};
    streamed_product<R, T, 3, true>(acc, Cw, kq, hdp, ldH, stages, L.stage_words, proj_in,
                                    [&](uint32_t (&a)[4], int m, int kw) {
                                      frag_a(a, Rb, ldR, m, kw);
                                    });
    prefetch(qkvt_in);   // dL/dLN(x)'s, ahead of the attention backward
#pragma unroll
    for (int jj = 0; jj < 3; ++jj) {
      const int d0 = 8 * (wn + 4 * jj);
      if (d0 >= hdp) break;
      tile_pairs(acc[jj], m0, d0, [&](int m, int d, float v0, float v1) {
        set2<T>(Db, ldH, m, d, round_to<T>(v0), round_to<T>(v1));
      });
    }
  }
  __syncthreads();
  {  // delta[i] = sum_d dO[i][d] O[i][d] = sum_j dP[i][j] P[i][j]
    const int i = threadIdx.x / kPerTok, part = threadIdx.x % kPerTok;
    float acc = 0.f;
    for (int d = part; d < hd; d += kPerTok) acc += get1<T>(Db, ldH, i, d) * get1<T>(Ob, ldH, i, d);
    acc = token_sum(acc);
    if (part == 0) delta[i] = acc;
  }
  // dWproj[o][h hd + d] += sum_t s dz[t][o] O[t][d]
  smem_product<R, 1>(
      C, hdp, Kp, [&](uint32_t (&a)[4], int m, int kw) { frag_a_t<T>(a, Rb, ldR, m, kw); },
      [&](uint32_t (&b)[2], int n0, int kw) { frag_b_t<T>(b, Ob, ldH, n0, kw); },
      [&](int mt, int nt, const float (&c)[4]) {
        tile_pairs(c, mt, nt, [&](int o, int d, float v0, float v1) {
          if (o < C && d < hd)
            atomicAdd(reinterpret_cast<float2*>(p.dwproj + static_cast<size_t>(o) * C + h * hd + d),
                      make_float2(v0, v1));
        });
      });
  __syncthreads();
  rows_in(x);   // R is free: x again, for LN(x)
  // dv = P^T dO, over O
  smem_product<R, 1>(
      kTok, hdp, Kp, [&](uint32_t (&a)[4], int m, int kw) { frag_a_t<T>(a, Pb, ldP, m, kw); },
      [&](uint32_t (&b)[2], int n0, int kw) { frag_b_t<T>(b, Db, ldH, n0, kw); },
      [&](int mt, int nt, const float (&c)[4]) {
        tile_pairs(c, mt, nt, [&](int m, int d, float v0, float v1) {
          set2<T>(Ob, ldH, m, d, round_to<T>(v0), round_to<T>(v1));
        });
      });
  __syncthreads();
  {  // dP = dO v^T, dS = P (dP - delta) in place of P, added into d rel_bias
    float dp[2][4] = {}, dp1[2][4] = {};   // even and odd k-steps
#pragma unroll 4
    for (int kw = 0; kw < Hw; kw += 8) {
      uint32_t a[4], al[4], b[2];
      frag_a(a, Db, ldH, m0, kw);
      split_a<R>(a, al);
#pragma unroll
      for (int jt = 0; jt < 2; ++jt) {
        frag_b(b, Vb, ldH, 16 * wn + 8 * jt, kw);
        mma3<R>((kw >> 3) & 1 ? dp1[jt] : dp[jt], a, al, b[0], b[1]);
      }
    }
#pragma unroll
    for (int jt = 0; jt < 2; ++jt)
#pragma unroll
      for (int r = 0; r < 4; ++r) dp[jt][r] += dp1[jt][r];
    float* drel = p.drel_bias + static_cast<size_t>(h) * n * n;
#pragma unroll
    for (int jt = 0; jt < 2; ++jt) {
      const int k0 = 16 * wn + 8 * jt;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int q = m0 + g + 8 * (r >> 1), key = k0 + 2 * tq + (r & 1);
        dp[jt][r] = get1<T>(Pb, ldP, q, key) * (dp[jt][r] - delta[q]);
      }
      if (n % 4 == 0) {
        red_tile4(dp[jt], m0, k0, [&](int q, int key) {
          return q < n && key < n ? drel + q * n + key : nullptr;
        });
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int q = m0 + g + 8 * (r >> 1), key = k0 + 2 * tq + (r & 1);
          if (q < n && key < n) atomicAdd(drel + q * n + key, dp[jt][r]);
        }
      }
      tile_pairs(dp[jt], m0, k0, [&](int q, int key, float v0, float v1) {
        set2<T>(Pb, ldP, q, key, round_to<T>(v0), round_to<T>(v1));
      });
    }
  }
  __syncthreads();
  // dq = scale dS k over dO, dk = dS^T q over v; LN(x) again into R
  smem_product<R, 1>(
      kTok, hdp, Kp, [&](uint32_t (&a)[4], int m, int kw) { frag_a(a, Pb, ldP, m, kw); },
      [&](uint32_t (&b)[2], int n0, int kw) { frag_b_t<T>(b, Kb, ldH, n0, kw); },
      [&](int mt, int nt, const float (&c)[4]) {
        tile_pairs(c, mt, nt, [&](int m, int d, float v0, float v1) {
          set2<T>(Db, ldH, m, d, round_to<T>(scale * v0), round_to<T>(scale * v1));
        });
      });
  smem_product<R, 1>(
      kTok, hdp, Kp, [&](uint32_t (&a)[4], int m, int kw) { frag_a_t<T>(a, Pb, ldP, m, kw); },
      [&](uint32_t (&b)[2], int n0, int kw) { frag_b_t<T>(b, Qb, ldH, n0, kw); },
      [&](int mt, int nt, const float (&c)[4]) {
        tile_pairs(c, mt, nt, [&](int m, int d, float v0, float v1) {
          set2<T>(Vb, ldH, m, d, round_to<T>(v0), round_to<T>(v1));
        });
      });
  cp_async_wait<0>();
  __syncthreads();
  layer_norm_rows(false);
  __syncthreads();
  // d bqkv: the sums of dq | dk | dv over the tokens, four lanes a row
  for (int e = threadIdx.x; e < 3 * hd * 4; e += kThreads) {   // whole warps: 4 | 32
    const int r = e >> 2, part = r >= 2 * hd ? 2 : r >= hd ? 1 : 0, d = r - part * hd;
    const uint32_t* G = part == 0 ? Db : part == 1 ? Vb : Ob;
    float acc = 0.f;
    for (int t = e & 3; t < n; t += 4) acc += get1<T>(G, ldH, t, d);
    acc += __shfl_xor_sync(__activemask(), acc, 1);
    acc += __shfl_xor_sync(__activemask(), acc, 2);
    if ((e & 3) == 0) atomicAdd(p.dbqkv + part * C + h * hd + d, acc);
  }
  {  // dL/dLN(x) += dqkv Wqkv[head rows], into the (tokens, C) buffer
    float acc[kMaxC / 32][4] = {};
    streamed_product<R, T, kMaxC / 32, true>(acc, 3 * Hw, kKw, C, ldR, stages, L.stage_words,
                                             qkvt_in, dqkv_a);
#pragma unroll
    for (int jj = 0; jj < kMaxC / 32; ++jj) {
      const int c0 = 8 * (wn + 4 * jj);
      if (c0 >= C) break;
      red_tile4(acc[jj], m0, c0, [&](int t, int c) {
        return t < n && c < C ? p.dln + token(t) * C + c : nullptr;
      });
    }
  }
  // dWqkv[row(r)][c] += sum_t dqkv[t][r] LN(x)[t][c]
  smem_product<R, 3>(   // 16 x 24 tiles: 48 at C = 180, three a warp
      3 * hdp, C, Kp,
      [&](uint32_t (&a)[4], int m, int kw) {
        const int part = part_of(m);
        frag_a_t<T>(a, part == 0 ? Db : part == 1 ? Vb : Ob, ldH, m - part * hdp, kw);
      },
      [&](uint32_t (&b)[2], int n0, int kw) { frag_b_t<T>(b, Rb, ldR, n0, kw); },
      [&](int mt, int nt, const float (&c)[4]) {
        red_tile4(c, mt, nt, [&](int r, int col) -> float* {
          return wrow[r] >= 0 && col < C ? p.dwqkv + static_cast<size_t>(wrow[r]) * C + col
                                         : nullptr;
        });
      });
}


template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(sizeof(T) == 4 ? 0 : 1, p.channels, p.heads);
  cudaError_t err = cudaFuncSetAttribute(swin_attn_block_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int windows = p.batch * (p.height / p.window) * (p.width / p.window);
  swin_attn_block_bwd_kernel<T><<<windows * p.heads, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tokens = p.batch * p.height * p.width;
  const LnBackwardParams ln{p.x, p.dz, p.dx, p.dln, tokens, p.channels, p.height * p.width,
                            p.mode, p.ln_w, p.s, p.dln_w, p.dln_b, p.dbproj};
  return launch_ln_backward<T>(ln, stream);
}

}  // namespace

extern "C" {

// Shared memory one thread block of the (window, head) kernel takes, in
// bytes; dtype 0 float32, 1 bfloat16.
size_t swin_attn_block_bwd_smem_bytes(int dtype, int channels, int heads) {
  return bwd_smem_bytes(dtype, channels, heads);
}

// Number of floats in the gradient buffer: d ln_w (C), d ln_b (C),
// d Wqkv (3C * C), d bqkv (3C), d Wproj (C * C), d bproj (C),
// d rel_bias (heads * n * n), in this order.
size_t swin_attn_block_bwd_grad_floats(int channels, int heads, int window) {
  const size_t C = channels, n = static_cast<size_t>(window) * window;
  return 6 * C + 4 * C * C + heads * n * n;
}

// dtype: 0 float32, 1 bfloat16; mode: 0 branch, 1 branch + x, 2 s * branch + x.
// scratch: batch * height * width * channels floats. Zeroes `grads` and
// `scratch` on the stream, then launches the two kernels. Returns the
// cudaError_t (0 on success); cudaErrorInvalidValue for C > 256, a head dim
// over 96 or a window over 64 tokens.
int swin_attn_block_bwd(int dtype, const void* x, const void* dz, void* dx, int batch, int height,
                        int width, int channels, int heads, int window, const float* ln_w,
                        const float* ln_b, const void* wqkv, const float* bqkv,
                        const void* wproj, const float* rel_bias, const float* mask, int mode,
                        const float* s, float scale, float* grads, float* scratch,
                        void* stream) {
  if (channels > kMaxC || round_up16(channels / heads) > kMaxHeadPadded ||
      window * window > kTok)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t C = channels;
  cudaError_t err = cudaMemsetAsync(
      grads, 0, swin_attn_block_bwd_grad_floats(channels, heads, window) * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(scratch, 0, static_cast<size_t>(batch) * height * width * C * sizeof(float),
                        st);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* dln_w = grads;
  float* dln_b = dln_w + C;
  float* dwqkv = dln_b + C;
  float* dbqkv = dwqkv + 3 * C * C;
  float* dwproj = dbqkv + 3 * C;
  float* dbproj = dwproj + C * C;
  float* drel_bias = dbproj + C;
  const Params p{x,     dz,    dx,    batch,  height, width,  channels,  heads,   window,
                 ln_w,  ln_b,  wqkv,  bqkv,   wproj,  rel_bias, mask,    mode,    s,
                 scale, dln_w, dln_b, dwqkv,  dbqkv,  dwproj, dbproj,    drel_bias, scratch};
  if (dtype == 0) return launch<float>(p, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* swin_attn_block_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
