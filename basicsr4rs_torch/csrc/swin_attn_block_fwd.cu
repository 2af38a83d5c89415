// Swin attention branch, forward (K2): LN -> qkv -> windowed multi-head
// attention with relative-position bias and shift mask -> proj, every
// product on the tensor cores.
//
// Replaces basicsr4rs_tpu/ops/swin_block.py::_block_fwd_kernel (the Pallas
// kernel behind fused_swin_attn_block). For x (B, H, W, C), already rolled
// by the caller, it writes
//
//   z = proj(W-MSA(LN(x)))   as   z,   z + x,   or   s[b] * z + x
//
// (the last folds DropPath's per-sample scale and the residual into the
// kernel). LN statistics, the softmax and every sum are float32; LN(x), q *
// scale, k, v, P and the attention output are rounded to the model dtype T
// (float32 or bfloat16) before the product that reads them.
//
// Bound on an H100: operations. 8 C^2 + 4 n C FLOP a token (2.81 GFLOP at
// B=4 48x48, C=180, window 8): 0.0171 ms as 3xTF32 at 495 TFLOP/s in
// float32, 0.0028 ms in bfloat16 at 989 (0.042 ms on the CUDA cores, this
// kernel's first route).
//
// What held the first route back, and what this design does about it:
// 1. Every product ran on the CUDA cores. Now each is an mma.sync
//    (branch_bwd.cuh's fragments, as K3 and K5): 3xTF32 m16n8k8 with the
//    truncating split in float32, m16n8k16 in bfloat16, float32 sums.
// 2. A window a block took 207 KB of shared memory at C = 180, one block an
//    SM: 144 windows (the training call) on 132 SMs ran in two waves, the
//    second 12 blocks. And C = 240 did not fit (255,312 bytes). Now two
//    launches from one call:
//    (a) swin_attn_fwd_head_kernel, one block a (window, head) unit (864 at
//        the training call with 6 heads, 93.5% of the SMs filled over the
//        kernel's time): the window's tokens of x by cp.async, LN in place
//        (each head's unit recomputes it; x comes from L2), that head's q | k
//        | v = LN(x) Wqkv[head rows]^T + b (N = 3 x the head dim padded to
//        16, 96 rows a product), S = (scale q) k^T with a warp's 16 queries
//        by 16 keys, the softmax across the four warps of a query tile
//        through shared memory with one reciprocal a row, P (rounded to T)
//        over LN(x)'s dead rows, and O = P v into a (B, H, W, C) scratch in T
//        by window addressing.
//    (b) swin_attn_fwd_proj_kernel, one block a (64-token tile, 96 output
//        columns) unit: O Wproj^T and the mode's epilogue (+ bproj, the
//        scale, + x) from the accumulators to the output, written once.
//    A product's 96 weight rows come in whole, by cp.async with the rows of
//    x (or of O): the first route's and K3's three stages a product waited
//    and synchronised at every step of 64 words of K, and with one block an
//    SM each wait was exposed (43% of a unit's clock at C = 180). A unit's
//    shared memory grows with C and the head dim, not with C x heads: C =
//    240 in heads of 30 takes 186 KB in (a), 156 KB in (b).
//    No atomics: a second launch on the same inputs repeats bit for bit.

#include "branch_bwd.cuh"

namespace {

using namespace swin;

struct Params {
  const void* x;
  void* out;
  void* ao;  // (tokens, C) in T: the attention output, between the two launches
  int batch, height, width, channels, heads, window;
  const float* ln_w;
  const float* ln_b;
  const void* wqkv;  // (3C, C)
  const float* bqkv;
  const void* wproj;  // (C, C)
  const float* bproj;
  const float* rel_bias;  // (heads, n, n)
  const float* mask;      // (nW, n, n) or null
  int mode;
  const float* s;  // (B,) when mode == kScaled
  float scale;
};

constexpr int kRows = 96;   // output rows of a product: a 16 x 24 tile a warp, 16 warps

// Words of K a product reads: C's, rounded up to 16 (the buffers are zero
// past C)
__host__ __device__ inline int k_words(int channels, int P) { return round_up16(channels / P); }

// (a)'s word offsets; P features of the model dtype a word. R (x, LN(x),
// then P) at 0; W: 96 weight rows of q|k|v, whole
struct HeadLayout {
  int ldR, ldH, ldP;   // pitches: C features (rounded up to 16 words), hdp features, 64 keys
  int q, k, v, w, red, tables, words;
};

__host__ __device__ inline HeadLayout head_layout(int channels, int heads, int P) {
  const int hdp = round_up16(channels / heads);
  HeadLayout l;
  l.ldR = pitch(k_words(channels, P));
  l.ldH = pitch(hdp / P);
  l.ldP = pitch(kTok / P);
  l.q = kTok * imax(l.ldR, l.ldP);
  l.k = l.q + kTok * l.ldH;
  l.v = l.k + kTok * l.ldH;
  l.w = l.v + kTok * l.ldH;
  l.red = l.w + kRows * l.ldR;   // the softmax's row maxima and sums
  l.tables = l.red + kRed;       // each token's index, each padded qkv row's Wqkv row
  l.words = l.tables + kTok + 3 * hdp;
  return l;
}

// (b)'s: the tile of the attention output (64 rows), then Wproj's 96 rows
size_t proj_words(int channels, int P) {
  return static_cast<size_t>(kTok + kRows) * pitch(k_words(channels, P));
}

size_t smem_bytes(int dtype, int channels, int heads, int launch) {
  return 4 * (launch == 0 ? static_cast<size_t>(head_layout(channels, heads, dtype + 1).words)
                          : proj_words(channels, dtype + 1));
}

// Blocks an SM each launch is compiled for: two in bfloat16, whose units
// take 82 KB (a) and 64 KB (b) at C = 180; one in float32 (156 KB, 125 KB)
template <typename T>
constexpr int kBlocks = sizeof(T) == 2 ? 2 : 1;

template <typename T>
__device__ __forceinline__ const uint32_t* words_at(const void* w, size_t element) {
  return reinterpret_cast<const uint32_t*>(static_cast<const T*>(w) + element);
}

// ------------------------------------------------- (a) one (window, head) unit
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocks<T>) swin_attn_fwd_head_kernel(const Params p) {
  constexpr Route R = sizeof(T) == 4 ? kTF32x3 : kBF16;
  constexpr int P = 4 / sizeof(T);   // features of T a word
  constexpr int kCopyRow = P == 1 ? 4 : 2;   // words a copy of a row (C % 4 == 0)
  extern __shared__ __align__(16) uint32_t smem[];

  const int H = p.height, W = p.width, C = p.channels, heads = p.heads;
  const int ws = p.window, n = ws * ws, hd = C / heads, hdp = round_up16(hd);
  const int h = blockIdx.x % heads, unit_window = blockIdx.x / heads;
  const int nww = W / ws, nw = (H / ws) * nww;
  const int img = unit_window / nw, win = unit_window % nw;
  const int row0 = (win / nww) * ws, col0 = (win % nww) * ws;
  const float* mask = p.mask ? p.mask + static_cast<size_t>(win) * n * n : nullptr;
  const float scale = p.scale;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3, m0 = (warp & 3) * 16, wn = warp >> 2;

  const HeadLayout L = head_layout(C, heads, P);
  const int ldR = L.ldR, ldH = L.ldH, ldP = L.ldP;
  uint32_t* Rb = smem;           // x, LN(x); then P, rows of queries
  uint32_t* Qb = smem + L.q;     // q (scaled)
  uint32_t* Kb = smem + L.k;
  uint32_t* Vb = smem + L.v;
  uint32_t* Wb = smem + L.w;     // 96 rows of Wqkv[head], C words of K each
  float* red = reinterpret_cast<float*>(smem + L.red);
  int* tok_at = reinterpret_cast<int*>(smem + L.tables);   // token t's index in x
  int* wrow = tok_at + kTok;   // padded row r of q|k|v: its Wqkv row, or -1
  const int Cw = C / P, Kw = k_words(C, P), Hw = hdp / P, Kp = kTok / P;

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
  auto weights_in = [&](int chunk) {   // q|k|v rows 96 chunk .. into W, one commit group
    stage_in<kCopyRow>(Wb, ldR, min(kRows, 3 * hdp - kRows * chunk), Kw, Cw,
                       [&, chunk](int r) -> const uint32_t* {
                         const int row = wrow[kRows * chunk + r];
                         return row >= 0 ? words_at<T>(p.wqkv, static_cast<size_t>(row) * C)
                                         : nullptr;
                       },
                       p.x);
  };
  // the n tokens' rows of x into R, zero for the tokens >= n and the words
  // from C to Kw; then the first product's weights, which land during LN
  stage_in<kCopyRow>(Rb, ldR, kTok, Kw, Cw, [&](int t) -> const uint32_t* {
    return t < n ? words_at<T>(p.x, token(t) * C) : nullptr;
  }, p.x);
  weights_in(0);
  // this warp's bias and mask entries of S (16 queries by keys 16 wn ..),
  // loaded now and added where S needs them, so that the loads from L2 run
  // under the copies and the qkv product
  float rb[2][4], mb[2][4];
  {
    const float* bias = p.rel_bias + static_cast<size_t>(h) * n * n;
#pragma unroll
    for (int jt = 0; jt < 2; ++jt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int q = m0 + g + 8 * (r >> 1), key = 16 * wn + 8 * jt + 2 * tq + (r & 1);
        const bool in = q < n && key < n;
        rb[jt][r] = in ? bias[q * n + key] : 0.f;
        mb[jt][r] = in && mask ? mask[q * n + key] : 0.f;
      }
  }
  cp_async_wait<1>();   // x
  __syncthreads();
  // LN(x) in place, a warp a token. Rolled loops: this runs once a unit, and
  // straight-line code is fetched from L2 as it runs.
  for (int t = warp; t < n; t += kWarps) {
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
    const float mean = sum / C, inv = rsqrtf(ss / C - mean * mean + 1e-5f);
    for (int c = lane; c < C; c += 32)
      set1<T>(Rb, ldR, t, c,
              round_to<T>((get1<T>(Rb, ldR, t, c) - mean) * inv * p.ln_w[c] + p.ln_b[c]));
  }

  // q (scaled), k, v of head h, 96 rows of q|k|v at a time, with no wait
  // inside a product: its weights are whole in W
  for (int chunk = 0; chunk * kRows < 3 * hdp; ++chunk) {
    cp_async_wait<0>();
    __syncthreads();   // LN(x) and this chunk's weights
    smem_product<R, 3>(
        kTok, min(kRows, 3 * hdp - kRows * chunk), Kw,
        [&](uint32_t (&a)[4], int m, int kw) { frag_a(a, Rb, ldR, m, kw); },
        [&](uint32_t (&b)[2], int o, int kw) { frag_b(b, Wb, ldR, o, kw); },
        [&](int mt, int nt, const float (&c)[4]) {
          tile_pairs(c, mt, nt, [&](int m, int o, float v0, float v1) {
            const int r = kRows * chunk + o, part = part_of(r), d = r - part * hdp;
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
        });
    if ((chunk + 1) * kRows < 3 * hdp) {   // heads of more than 32 features
      __syncthreads();   // every warp is done with W
      weights_in(chunk + 1);
    }
  }
  __syncthreads();

  {  // P = softmax(S + bias (+ mask)): this warp's 16 queries by keys 16 wn ..
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
    float sc[2][4], mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jt = 0; jt < 2; ++jt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int q = m0 + g + 8 * (r >> 1), key = 16 * wn + 8 * jt + 2 * tq + (r & 1);
        // (bias + mask) + q.k, as the plain version; keys past n drop out
        sc[jt][r] = key >= n ? -INFINITY
                    : q < n  ? (rb[jt][r] + mb[jt][r]) + (qk[0][jt][r] + qk[1][jt][r])
                             : 0.f;
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
    // one reciprocal a row: a division an entry takes the IEEE slow path on
    // the shift mask's denormal probabilities; a padded query's row is zero
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = m0 + g + 8 * i;
      sum[i] = q < n ? 1.f / (rsum[q] + rsum[kTok + q] + rsum[2 * kTok + q] + rsum[3 * kTok + q])
                     : 0.f;
    }
#pragma unroll
    for (int jt = 0; jt < 2; ++jt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        set2<T>(Rb, ldP, m0 + g + 8 * i, 16 * wn + 8 * jt + 2 * tq,
                round_to<T>(sc[jt][2 * i] * sum[i]), round_to<T>(sc[jt][2 * i + 1] * sum[i]));
  }
  __syncthreads();
  // O = P v, rounded to T, into the scratch at the head's features
  T* ao = static_cast<T*>(p.ao);
  smem_product<R, 1>(
      kTok, hdp, Kp, [&](uint32_t (&a)[4], int m, int kw) { frag_a(a, Rb, ldP, m, kw); },
      [&](uint32_t (&b)[2], int n0, int kw) { frag_b_t<T>(b, Vb, ldH, n0, kw); },
      [&](int mt, int nt, const float (&c)[4]) {
        tile_pairs(c, mt, nt, [&](int m, int d, float v0, float v1) {
          if (m < n && d < hd) store2(ao + token(m) * C + h * hd + d, v0, v1);
        });
      });
}

// ------------------------------------- (b) one (64-token tile, 96 columns) unit
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocks<T>) swin_attn_fwd_proj_kernel(const Params p) {
  constexpr Route R = sizeof(T) == 4 ? kTF32x3 : kBF16;
  constexpr int P = 4 / sizeof(T);
  constexpr int kCopyRow = P == 1 ? 4 : 2;
  extern __shared__ __align__(16) uint32_t smem[];

  const int C = p.channels, tokens = p.batch * p.height * p.width;
  const int chunks = (C + kRows - 1) / kRows;
  const int tok0 = blockIdx.x / chunks * kTok, o_base = blockIdx.x % chunks * kRows;
  const int N = min(kRows, C - o_base);
  const int Cw = C / P, Kw = k_words(C, P), ld = pitch(Kw);
  uint32_t* A = smem;              // rows of the attention output, a token a row
  uint32_t* Wp = smem + kTok * ld;   // Wproj's rows o_base .., C words of K each
  stage_in<kCopyRow>(A, ld, kTok, Kw, Cw, [&](int t) -> const uint32_t* {
    return tok0 + t < tokens ? words_at<T>(p.ao, static_cast<size_t>(tok0 + t) * C) : nullptr;
  }, p.x);
  stage_in<kCopyRow>(Wp, ld, N, Kw, Cw, [&](int r) -> const uint32_t* {
    return words_at<T>(p.wproj, static_cast<size_t>(o_base + r) * C);
  }, p.x);
  cp_async_wait<0>();
  __syncthreads();
  // the product and the mode's epilogue, from the accumulators to the output
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  const int per_sample = p.height * p.width;
  smem_product<R, 3>(
      kTok, N, Kw, [&](uint32_t (&a)[4], int m, int kw) { frag_a(a, A, ld, m, kw); },
      [&](uint32_t (&b)[2], int o, int kw) { frag_b(b, Wp, ld, o, kw); },
      [&](int mt, int nt, const float (&c)[4]) {
        tile_pairs(c, mt, nt, [&](int m, int o, float v0, float v1) {
          const int tok = tok0 + m, col = o_base + o;
          if (tok >= tokens || o >= N) return;   // N is even: a tile may run past it (84 at C = 180)
          const float s = p.mode == kScaled ? p.s[tok / per_sample] : 1.f;
          const size_t at = static_cast<size_t>(tok) * C + col;
          float z0 = (v0 + p.bproj[col]) * s, z1 = (v1 + p.bproj[col + 1]) * s;
          if (p.mode != kBranch) {
            const float2 xv = load2(x + at);
            z0 += xv.x;
            z1 += xv.y;
          }
          store2(out + at, z0, z1);
        });
      });
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const int dtype = sizeof(T) == 4 ? 0 : 1;
  const size_t smem_a = smem_bytes(dtype, p.channels, p.heads, 0);
  const size_t smem_b = smem_bytes(dtype, p.channels, p.heads, 1);
  cudaError_t err = cudaFuncSetAttribute(swin_attn_fwd_head_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_a));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(swin_attn_fwd_proj_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_b));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int windows = p.batch * (p.height / p.window) * (p.width / p.window);
  swin_attn_fwd_head_kernel<T><<<windows * p.heads, kThreads, smem_a, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (p.batch * p.height * p.width + kTok - 1) / kTok;
  const int chunks = (p.channels + kRows - 1) / kRows;
  swin_attn_fwd_proj_kernel<T><<<tiles * chunks, kThreads, smem_b, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one thread block takes, in bytes: launch 0 the (window,
// head) units, 1 the proj tiles; dtype 0 float32, 1 bfloat16.
size_t swin_attn_block_fwd_smem_bytes(int dtype, int channels, int heads, int launch) {
  return smem_bytes(dtype, channels, heads, launch);
}

// dtype: 0 float32, 1 bfloat16; mode: 0 branch, 1 branch + x, 2 s * branch + x.
// scratch: batch * height * width * channels elements of the model dtype.
// Launches the two kernels; returns the cudaError_t (0 on success),
// cudaErrorInvalidValue for a window over 64 tokens.
int swin_attn_block_fwd(int dtype, const void* x, void* out, int batch, int height, int width,
                        int channels, int heads, int window, const float* ln_w,
                        const float* ln_b, const void* wqkv, const float* bqkv,
                        const void* wproj, const float* bproj, const float* rel_bias,
                        const float* mask, int mode, const float* s, float scale, void* scratch,
                        void* stream) {
  if (window * window > kTok) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x,    out,   scratch, batch, height,   width, channels, heads, window,
                 ln_w, ln_b,  wqkv,    bqkv,  wproj,    bproj, rel_bias, mask,  mode,
                 s,    scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* swin_attn_block_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
