// Transformer MLP branch, forward (K4), both products on the tensor cores.
//
// Replaces basicsr4rs_tpu/ops/mlp_block.py::_mlp_fwd_kernel (the Pallas
// kernel behind fused_mlp_block). For x (T, C) it writes
//
//   z = fc2(GELU(fc1(LN(x))))   as   z,   z + x,   or   s[sample] * z + x
//
// (the last folds DropPath's per-sample scale and the residual into the
// kernel). LN statistics, exact (erf) GELU and every sum are float32; LN(x)
// and GELU's output are rounded to the model dtype before the products.
//
// Bound on an H100: operations. Two products of 2 C hidden FLOP a token
// (2.39 GFLOP at B=4 48x48, C=180, hidden 360): 0.0145 ms as 3xTF32 at 495
// TFLOP/s in float32, 0.0024 ms in bfloat16 at 989 (0.036 ms on the CUDA
// cores, this kernel's first route). x and out move 13 MB in float32.
//
// The design, over branch_bwd.cuh's pieces (K5's recompute of the same two
// products):
// - every product is an mma.sync: 3xTF32 m16n8k8 with the truncating
//   hi/lo split in float32, m16n8k16 in bfloat16, float32 sums;
// - a unit is a tile of 64 tokens and a part of the hidden chunks of kChunk
//   columns. LN(x) and a chunk of g = GELU(h) sit token-major in shared
//   memory (pitch 4 mod 8 words), read as they are by ldmatrix: a warp owns
//   16 tokens and the n8 tiles wn + 4 jj, in fc1 (h = LN(x) W1[chunk]^T,
//   3 tiles) and fc2 (z += g W2[:, chunk]^T, NT = C / 32 tiles: 6 up to C =
//   192, 8 up to 256);
// - W1's chunk rows and W2's chunk columns stream from L2 through kStages
//   cp.async stages (product: streamed_product's loop with every tile's B
//   fragment loaded first and the mma.sync run term by term across the
//   tiles), a product's first two stages started ahead of the work before it;
// - fc2's sum over the chunks stays in registers for the whole unit (the
//   first route read and wrote it in shared memory on every chunk);
// - the waves: at B=4 48x48, 144 tiles on 132 SMs, one block an SM, ran as
//   a full wave and a wave of 12. The host plans `parts`: a tile's hidden
//   chunks are split across two blocks when the waves of (tile, part) units
//   take less time (plan_of; in float32 at that shape 288 units, 73% of
//   three waves' slots, against 55% of two). The part that finishes first
//   (a counter a tile) writes its float32 sums to a scratch and raises a
//   flag; the other adds them to its own and writes the tile. No atomic
//   touches a value, and a + b = b + a: the output repeats bit for bit.
// What held it back on the way (ops/joint_block_clock.py --kernel mlp_fwd,
// block 0 on an H100): the weight stream. With stages of 64 words of fc1
// and 32 of fc2 (six a chunk in float32) copied by stage_in, a warp a row,
// a float32 unit took 115.8k cycles, 80% of them in the products' stage
// loop; with stages of 96 and 48 words (two a chunk in float32, one in
// bfloat16) copied by every thread in turn, 79.7k.
// Any hidden with hidden % 4 == 0; C % 4 == 0, C <= kMaxC (256).

#include "branch_bwd.cuh"

namespace {

using namespace swin;

struct Params {
  const void* x;
  void* out;
  int tokens, channels, hidden, tokens_per_sample;
  const float* ln_w;
  const float* ln_b;
  const void* w1;  // (hidden, C)
  const float* b1;
  const void* w2;  // (C, hidden)
  const float* b2;
  int mode;
  const float* s;  // (samples,) when mode == kScaled
  int parts;       // blocks a tile's hidden chunks are split across: 1 or 2
  // parts == 2: (tiles, kTok, C) fc2 sums of the part that finishes first,
  // and two counters a tile, zeroed before the launch: parts done, sums written
  float* partial;
  int* arrived;
  int* ready;
};

constexpr int kChunk = 96;     // hidden columns a chunk: 3 n8 tiles a warp
constexpr int kK1 = 96;        // words of C a stage of fc1 holds
// words of a chunk a stage of fc2 holds: half a chunk of float32 words, all
// of bfloat16's, up to C = 192; past it 32, so that C = 240 fits
__host__ __device__ constexpr int fc2_stage_words(int channels) {
  return channels <= 192 ? 48 : 32;
}
constexpr int kMaxParts = 2;

// Word offsets of the buffers; P features of the model dtype a word.
struct FwdLayout {
  int ldR, ldH;        // pitches: C features, kChunk features
  int h, stages;       // LN(x) at 0, then a chunk of g, then the stages
  int stage_words, scale, flag, words;
};

__host__ __device__ inline FwdLayout fwd_layout(int channels, int P) {
  FwdLayout l;
  l.ldR = pitch(channels / P);
  l.ldH = pitch(kChunk / P);
  l.h = kTok * l.ldR;
  l.stages = l.h + kTok * l.ldH;
  // a stage: the chunk's W1 rows by kK1 words (fc1), or C rows (to a
  // multiple of 8) of W2 by kK2 words of the chunk (fc2)
  l.stage_words =
      imax(kChunk * (kK1 + 4), (channels + 7) / 8 * 8 * (fc2_stage_words(channels) + 4));
  l.scale = l.stages + kStages * l.stage_words;
  l.flag = l.scale + kTok;
  l.words = l.flag + 4;
  return l;
}

size_t fwd_smem_bytes(int dtype, int channels) {
  return static_cast<size_t>(fwd_layout(channels, dtype + 1).words) * 4;
}

// acc += A . B^T for the 64 tokens against B's N rows, from the weight
// stream's steps g0 .. g0 + ceil(Kw / kK) - 1 (ld words a row, kK words of K
// a step); a warp owns the tokens 16 (w % 4) .. and the n8 tiles w / 4 + 4 jj
// below N. As streamed_product (branch_bwd.cuh), with two differences: the
// stream runs on across the products (load(g) stages step g of the whole
// unit, kStages - 1 ahead, so that a product's first stages land during
// the one before), and a k-step loads every tile's B fragment first and
// runs the products term by term across the tiles (3xTF32: the small
// ones first), so that no mma.sync waits on the one before it. Returns the
// next product's first step; the block is not in step at its end.
template <Route R, int NT, class Load, class LA>
__device__ __forceinline__ int product(float (&acc)[NT][4], int Kw, int kK, int N, int ld,
                                       const uint32_t* stages, int stage_words, int g0,
                                       Load load, LA la) {
  const int warp = threadIdx.x >> 5, m0 = (warp & 3) * 16, wn = warp >> 2;
  const int steps = (Kw + kK - 1) / kK;
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // this step's stage has landed, the one read last step is free
    load(g0 + step + kStages - 1);
    const uint32_t* st = stages + (g0 + step) % kStages * stage_words;
    const int kw0 = step * kK, kn = min(kK, Kw - kw0);
#pragma unroll 4
    for (int ks = 0; ks < kn; ks += 8) {
      uint32_t a[4], al[4], b[NT][2], bl[NT][2];
      la(a, m0, kw0 + ks);
      split_a<R>(a, al);
#pragma unroll
      for (int jj = 0; jj < NT; ++jj) {
        if (8 * (wn + 4 * jj) >= N) continue;
        frag_b(b[jj], st, ld, 8 * (wn + 4 * jj), ks);
        if constexpr (R == kTF32x3) {
          split_fast(b[jj][0], b[jj][0], bl[jj][0]);
          split_fast(b[jj][1], b[jj][1], bl[jj][1]);
        }
      }
      if constexpr (R == kTF32x3) {
#pragma unroll
        for (int jj = 0; jj < NT; ++jj)
          if (8 * (wn + 4 * jj) < N) tc::mma_tf32(acc[jj], al, b[jj][0], b[jj][1]);
#pragma unroll
        for (int jj = 0; jj < NT; ++jj)
          if (8 * (wn + 4 * jj) < N) tc::mma_tf32(acc[jj], a, bl[jj][0], bl[jj][1]);
#pragma unroll
        for (int jj = 0; jj < NT; ++jj)
          if (8 * (wn + 4 * jj) < N) tc::mma_tf32(acc[jj], a, b[jj][0], b[jj][1]);
      } else {
#pragma unroll
        for (int jj = 0; jj < NT; ++jj)
          if (8 * (wn + 4 * jj) < N) tc::mma_bf16(acc[jj], a, b[jj][0], b[jj][1]);
      }
    }
  }
  return g0 + steps;
}

// cp.async of `rows` rows of a stage (kK words, pitch kK + 4), every thread
// on the (row, kCopy words) pairs in turn: word q < `words` of row r from
// row(r) + q where row(r) is not nullptr and q < valid, else zeros. One
// commit group. (stage_in's warp a row left most lanes idle on rows of 32
// to 96 words, and the copies set the pace.)
template <int kK, int kCopy, class Row>
__device__ __forceinline__ void stage_rows(uint32_t* st, int rows, int words, int valid, Row row,
                                           const void* any) {
  constexpr int kPer = kK / kCopy;
  for (int e = threadIdx.x; e < rows * kPer; e += kThreads) {
    const int r = e / kPer, q = (e - r * kPer) * kCopy;
    if (q >= words) continue;
    const uint32_t* src = row(r);
    const bool ok = src != nullptr && q < valid;
    cp_async_zfill<kCopy>(st + r * (kK + 4) + q, ok ? static_cast<const void*>(src + q) : any, ok);
  }
  cp_async_commit();
}

// ------------------------------------------------------------------ the unit
// One thread block for part blockIdx.x % parts of tile blockIdx.x / parts.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 1) mlp_block_fwd_kernel(const Params p) {
  constexpr Route R = sizeof(T) == 4 ? kTF32x3 : kBF16;
  constexpr int P = 4 / sizeof(T);           // features of T a word
  constexpr int kCopy = P == 1 ? 4 : 2;      // words a cp.async (C, hidden % 4 == 0)
  constexpr int kI = kMaxC / 32;
  constexpr int kK2 = fc2_stage_words(NT == 6 ? 192 : 256);
  extern __shared__ __align__(16) uint32_t smem[];

  const int C = p.channels, hidden = p.hidden, parts = p.parts;
  const int tile = blockIdx.x / parts, part = blockIdx.x % parts;
  const int tok0 = tile * kTok, n = imin(kTok, p.tokens - tok0);
  const int chunks = (hidden + kChunk - 1) / kChunk, per = (chunks + parts - 1) / parts;
  const int j_begin = part * per * kChunk, j_end = imin(hidden, (part + 1) * per * kChunk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3, m0 = (warp & 3) * 16, wn = warp >> 2;

  const FwdLayout L = fwd_layout(C, P);
  const int ldR = L.ldR, ldH = L.ldH;
  uint32_t* Rb = smem;             // LN(x)
  uint32_t* Hb = smem + L.h;       // g = GELU(h) of a chunk
  uint32_t* stages = smem + L.stages;
  float* scale = reinterpret_cast<float*>(smem + L.scale);   // each token's s
  int* flag = reinterpret_cast<int*>(smem + L.flag);
  const int Cw = C / P, C8 = (C + 7) / 8 * 8;
  const int Cpad = (Cw + 7) / 8 * 8 * P;   // features fc1 reads: zero past C
  const int fc1_steps = (Cw + kK1 - 1) / kK1;
  auto fc2_words = [&](int j0) { return round_up16(imin(kChunk, hidden - j0)) / P; };

  auto words_of = [](const void* w, size_t element) {
    return reinterpret_cast<const uint32_t*>(static_cast<const T*>(w) + element);
  };
  // the weight stream: for each chunk, fc1's steps (rows j of W1[chunk], kK1
  // words of C), then fc2's (rows c of W2, kK2 words of the chunk's
  // columns). load(gs) stages step gs in slot gs % kStages, one commit
  // group; empty past the unit's last step.
  auto load = [&](int gs) {
    uint32_t* st = stages + gs % kStages * L.stage_words;
    for (int j0 = j_begin; j0 < j_end; j0 += kChunk) {
      const int hc = imin(kChunk, hidden - j0);
      if (gs < fc1_steps) {
        const int kw0 = gs * kK1, kn = (imin(kK1, Cw - kw0) + 7) & ~7;
        stage_rows<kK1, kCopy>(st, round_up16(hc), kn, Cw - kw0, [&](int r) -> const uint32_t* {
          return r < hc ? words_of(p.w1, static_cast<size_t>(j0 + r) * C) + kw0 : nullptr;
        }, p.x);
        return;
      }
      gs -= fc1_steps;
      const int Hw = fc2_words(j0);
      if (gs * kK2 < Hw) {
        const int kw0 = gs * kK2, kn = (imin(kK2, Hw - kw0) + 7) & ~7;
        stage_rows<kK2, kCopy>(st, C8, kn, hc / P - kw0, [&](int r) -> const uint32_t* {
          return r < C ? words_of(p.w2, static_cast<size_t>(r) * hidden + j0) + kw0 : nullptr;
        }, p.x);
        return;
      }
      gs -= (Hw + kK2 - 1) / kK2;
    }
    cp_async_commit();
  };
  load(0);
  load(1);
  // x's n rows, zero for the tokens >= n and the features from C to Cpad
  stage_in<kCopy>(Rb, ldR, kTok, Cpad / P, Cw, [&](int t) -> const uint32_t* {
    return t < n ? words_of(p.x, static_cast<size_t>(tok0 + t) * C) : nullptr;
  }, p.x);
  // while they are in flight: this lane's LayerNorm parameters (features
  // lane + 32 i) and each token's DropPath scale
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
  cp_async_wait<0>();
  __syncthreads();
  layer_norm_rows<T>(Rb, ldR, n, C, lw, lb);

  float acc[NT][4] = {};   // fc2's sums over the part's chunks: tokens m0 .., tiles wn + 4 jj
  int gs = 0;
  for (int j0 = j_begin; j0 < j_end; j0 += kChunk) {
    const int hc = imin(kChunk, hidden - j0), hcp = round_up16(hc);
    float h[3][4] = {};
    gs = product<R, 3>(h, Cw, kK1, hcp, kK1 + 4, stages, L.stage_words, gs, load,
                       [&](uint32_t (&a)[4], int m, int k) { frag_a(a, Rb, ldR, m, k); });
#pragma unroll
    for (int jj = 0; jj < 3; ++jj) {   // g = GELU(h + b1), rounded; zero past hc
      const int o0 = 8 * (wn + 4 * jj), j = o0 + 2 * tq;
      if (o0 >= hcp) break;
      const bool col = j < hc;   // hc % 4 == 0: j + 1 < hc too
      const float b0 = col ? p.b1[j0 + j] : 0.f, b1 = col ? p.b1[j0 + j + 1] : 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        set2<T>(Hb, ldH, m0 + g + 8 * i, j, col ? round_to<T>(gelu(h[jj][2 * i] + b0)) : 0.f,
                col ? round_to<T>(gelu(h[jj][2 * i + 1] + b1)) : 0.f);
    }
    gs = product<R, NT>(acc, fc2_words(j0), kK2, C, kK2 + 4, stages, L.stage_words, gs, load,
                        [&](uint32_t (&a)[4], int m, int k) { frag_a(a, Hb, ldH, m, k); });
  }

  // f(jj, i, token, column) over this warp's pairs of fc2's sums, columns < C
  // (a tile at C = 180 runs past it: 176 .. 183)
  auto pairs = [&](auto f) {
#pragma unroll
    for (int jj = 0; jj < NT; ++jj) {
      const int c = 8 * (wn + 4 * jj) + 2 * tq;
      if (c >= C) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) f(jj, i, m0 + g + 8 * i, c);
    }
  };
  bool writes = true;   // this block writes the tile's output
  if (parts > 1) {   // two parts: the first to finish hands its sums to the other
    __syncthreads();   // every warp is done with the stages and flag is free
    if (threadIdx.x == 0) *flag = atomicAdd(p.arrived + tile, 1);
    __syncthreads();
    float* sums = p.partial + static_cast<size_t>(tile) * kTok * C;
    writes = *flag != 0;
    if (!writes) {
      pairs([&](int jj, int i, int m, int c) {
        *reinterpret_cast<float2*>(sums + m * C + c) = make_float2(acc[jj][2 * i],
                                                                   acc[jj][2 * i + 1]);
      });
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) atomicExch(p.ready + tile, 1);
    } else {
      // the other part came first and is writing (it is resident: no
      // deadlock): wait for its sums and add them; a + b = b + a, so the
      // bits do not depend on which part came first
      if (threadIdx.x == 0)
        while (atomicAdd(p.ready + tile, 0) == 0) __nanosleep(64);
      __syncthreads();
      __threadfence();
      pairs([&](int jj, int i, int m, int c) {
        const float2 u = __ldcg(reinterpret_cast<const float2*>(sums + m * C + c));
        acc[jj][2 * i] += u.x;
        acc[jj][2 * i + 1] += u.y;
      });
    }
  }
  if (writes) {   // out = z + b2 as the mode says, tokens < n; every load before a store
    const T* x = static_cast<const T*>(p.x);
    T* out = static_cast<T*>(p.out);
    pairs([&](int jj, int i, int m, int c) {
      float z0 = acc[jj][2 * i] + p.b2[c], z1 = acc[jj][2 * i + 1] + p.b2[c + 1];
      if (p.mode == kScaled) {
        z0 *= scale[m];
        z1 *= scale[m];
      }
      if (p.mode != kBranch && m < n) {
        const float2 xv = load2(x + static_cast<size_t>(tok0 + m) * C + c);
        z0 += xv.x;
        z1 += xv.y;
      }
      acc[jj][2 * i] = z0;
      acc[jj][2 * i + 1] = z1;
    });
    pairs([&](int jj, int i, int m, int c) {
      if (m < n)
        store2(out + static_cast<size_t>(tok0 + m) * C + c, acc[jj][2 * i], acc[jj][2 * i + 1]);
    });
  }
}

template <typename T, int NT>
int launch_tiles(const Params& p, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(sizeof(T) == 4 ? 0 : 1, p.channels);
  cudaError_t err = cudaFuncSetAttribute(mlp_block_fwd_kernel<T, NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (p.tokens + kTok - 1) / kTok;
  mlp_block_fwd_kernel<T, NT><<<tiles * p.parts, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  return p.channels <= 192 ? launch_tiles<T, 6>(p, stream) : launch_tiles<T, 8>(p, stream);
}

template <typename T, int NT>
const void* kernel_of() {
  return reinterpret_cast<const void*>(mlp_block_fwd_kernel<T, NT>);
}

// Blocks an SM and SMs of the kernel for (dtype, C) on the current device
// (the wrapper keeps the plan of each shape).
cudaError_t occupancy(int dtype, int channels, int& per_sm, int& sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool wide = channels > 192;
  const void* kernel = dtype == 0 ? (wide ? kernel_of<float, 8>() : kernel_of<float, 6>())
                                  : (wide ? kernel_of<__nv_bfloat16, 8>()
                                          : kernel_of<__nv_bfloat16, 6>());
  const size_t smem = fwd_smem_bytes(dtype, channels);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  return per_sm == 0 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// The parts (1 or 2) that take the least time for `tiles` tiles of `chunks`
// chunks on `slots` blocks at once: the waves of units, each a part's chunks
// and what a unit does besides (x's copy, LN(x), the tile's output; the
// hand-over, split), counted in chunks. Those two, by the unit's clock on an
// H100 at B=4 48x48 (ops/joint_block_clock.py --kernel mlp_fwd): 0.65 and
// 0.2 chunks in float32, 1.6 and 0.45 in bfloat16, whose products take less
// than half the time. A part must not come out empty.
int plan_of(int dtype, int tiles, int chunks, int slots) {
  const double fixed = dtype == 0 ? 0.65 : 1.6, split = dtype == 0 ? 0.2 : 0.45;
  int best = 1;
  double best_cost = 0.;
  for (int parts = 1; parts <= imin(chunks, kMaxParts); ++parts) {
    const int per = (chunks + parts - 1) / parts;
    if ((parts - 1) * per >= chunks) continue;
    const long long waves = (static_cast<long long>(tiles) * parts + slots - 1) / slots;
    const double cost = waves * (per + fixed + (parts > 1 ? split : 0.));
    if (parts == 1 || cost < best_cost) {
      best = parts;
      best_cost = cost;
    }
  }
  return best;
}

}  // namespace

extern "C" {

// Shared memory one thread block takes, in bytes; dtype 0 float32, 1 bfloat16.
size_t mlp_block_fwd_smem_bytes(int dtype, int channels) {
  return fwd_smem_bytes(dtype, channels);
}

// The grid for `tokens` tokens on the current device: plan = {units, parts,
// blocks an SM, SMs, floats of scratch}; a unit is one thread block for (tile
// of 64 tokens, part of its hidden chunks). Returns the cudaError_t of the
// queries.
int mlp_block_fwd_plan(int dtype, int tokens, int channels, int hidden, int* plan) {
  int per_sm = 0, sms = 0;
  const cudaError_t err = occupancy(dtype, channels, per_sm, sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (tokens + kTok - 1) / kTok, chunks = (hidden + kChunk - 1) / kChunk;
  const int parts = plan_of(dtype, tiles, chunks, per_sm * sms);
  plan[0] = tiles * parts;
  plan[1] = parts;
  plan[2] = per_sm;
  plan[3] = sms;
  plan[4] = parts > 1 ? tiles * (kTok * channels + 2) : 0;
  return 0;
}

// dtype: 0 float32, 1 bfloat16; mode: 0 branch, 1 branch + x, 2 s * branch +
// x; parts: the plan's. scratch: with two parts, the plan's floats (tiles =
// ceil(tokens / 64) of 64 x C sums, then two counters a tile, which this
// call zeroes on the stream); else null. Returns the cudaError_t (0 on
// success); cudaErrorInvalidValue for C > 256 or parts out of range.
int mlp_block_fwd(int dtype, const void* x, void* out, int tokens, int channels, int hidden,
                  int tokens_per_sample, const float* ln_w, const float* ln_b, const void* w1,
                  const float* b1, const void* w2, const float* b2, int mode, const float* s,
                  int parts, float* scratch, void* stream) {
  if (channels > kMaxC || parts < 1 || parts > kMaxParts || (parts > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t tiles = (static_cast<size_t>(tokens) + kTok - 1) / kTok;
  float* partial = nullptr;
  int* arrived = nullptr;
  if (parts > 1) {
    partial = scratch;
    arrived = reinterpret_cast<int*>(scratch + tiles * kTok * channels);
    const cudaError_t err = cudaMemsetAsync(arrived, 0, 2 * tiles * sizeof(int), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Params p{x,  out,  tokens, channels, hidden,  tokens_per_sample, ln_w, ln_b,  w1,
                 b1, w2,   b2,     mode,     s,       parts,             partial, arrived,
                 arrived == nullptr ? nullptr : arrived + tiles};
  if (dtype == 0) return launch<float>(p, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mlp_block_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
