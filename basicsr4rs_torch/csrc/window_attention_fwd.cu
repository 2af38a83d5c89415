// Windowed multi-head attention from packed q|k|v, forward, both products
// on the tensor cores.
//
// Replaces basicsr4rs_tpu/ops/window_attention.py::_attention_kernel. For
// qkv (B, H, W, 3C) and a float32 bias (nWb, heads, n, n), nWb 1 or the
// windows of one image, it writes
//
//   out[window, head] = softmax(scale * q k^T + bias) v        (B, H, W, C)
//
// with q * scale rounded to the model dtype T, the softmax in float32 and P
// rounded to T before P v. The qkv and proj GEMMs stay outside, as in the
// TPU kernel.
//
// What bounds it on an H100: bytes. A token brings 3C values in and takes C
// out for 4 n C FLOP (B=16 64x64, C=192, n=64, shifted: 208 MB with the
// bias, 0.062 ms at 3.35 TB/s in float32, 0.032 ms in bfloat16, against
// 3.2 GFLOP, 0.020 ms as 3xTF32 at 495 TFLOP/s). The first route ran both
// products on the CUDA cores, loaded a scalar at a time with a division and
// a modulo each, and divided every probability by its row sum (14% of the
// float32 bound, 7% of bfloat16's, slower than SDPA in bfloat16). Now it is
// the backward's unit (window_attention.cuh) with two of its five products:
// - one block a (window position, head, group of samples), NT warps (4 up
//   to 64 tokens, 6 up to 96), a warp 16 queries; the bias slab of the unit
//   comes in once, q, k, v a sample at a time by cp.async, the next one's
//   in a second stage while the current one computes where that does not
//   cost blocks an SM (the plan, chosen on the host and kept per shape);
// - S = (scale q) k^T on mma.sync (3xTF32 m16n8k8 with the truncating
//   split in float32, m16n8k16 in bfloat16), the softmax on its accumulator
//   fragments, one reciprocal a row;
// - P, rounded to T, goes to shared memory once, into the warp's own rows,
//   and is read back as the A fragment of O = P v (v token-major, read
//   transposed: by index in float32, by ldmatrix.trans in bfloat16); a
//   warp reads only its own rows of P, so no barrier sits between the two
//   products;
// - O leaves from the accumulators into its (B, H, W, C) place, two
//   features a store: no window partition or reverse copy.

#include "window_attention.cuh"

namespace {

using swin::Route;
using wattn::Geometry;
using wattn::kMaxHt;

constexpr int kParts = 3;   // head buffers a stage: q, k, v

size_t smem_bytes(int dtype, int channels, int heads, int window, int stages) {
  return wattn::smem_bytes(kParts, dtype, channels, heads, window, stages);
}

// Blocks an SM a launch is compiled for: four of 4 warps (128 registers a
// thread at most), two of 6
template <typename T, int NT>
__global__ void __launch_bounds__(32 * NT, NT == 4 ? 4 : 2)
    window_attention_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                                T* __restrict__ out, const Geometry g,
                                const int samples_per_unit, const int stages) {
  constexpr Route R = sizeof(T) == 4 ? swin::kTF32x3 : swin::kBF16;
  constexpr int P = 4 / sizeof(T);
  constexpr int kThreads = 32 * NT, kNp = 16 * NT, kJt = 2 * NT;   // kJt: n8 tiles of keys
  extern __shared__ __align__(16) uint32_t smem[];

  const int C = g.channels, n = g.window * g.window, hd = C / g.heads;
  const int hdp = swin::round_up16(hd), Hw = hdp / P, Kp = kNp / P, ht = hdp / 8;
  const wattn::Layout L = wattn::layout_of(kParts, C, g.heads, g.window, P, stages);
  const int ldB = L.ldB, ldH = L.ldH, ldP = L.ldP;
  const wattn::Unit u = wattn::unit_of(g, samples_per_unit);
  const int m0 = 16 * (threadIdx.x >> 5);

  const float* Bs = reinterpret_cast<const float*>(smem + L.bias);
  uint32_t* Ps = smem + L.ps;   // P: rows of queries
  int* at = reinterpret_cast<int*>(smem + L.tokens);   // token t's place in the image
  auto stage = [&](int s) -> uint32_t* { return smem + L.stage + s * kParts * kNp * ldH; };
  wattn::unit_start<kThreads>(at, smem + L.bias, ldB, bias + u.slab, g, u.win, kNp);
  __syncthreads();   // the token table

  const int kc = wattn::copy_words<P>(C, hd);
  auto load = [&](int img, uint32_t* st) {
    uint32_t* const dst[kParts] = {st, st + kNp * ldH, st + 2 * kNp * ldH};
    wattn::load_sample<T, kParts, kThreads>(dst, qkv, nullptr, at, g, img, u.h, kNp, ldH, kc);
  };
  const bool paired = C % 2 == 0 && hd % 2 == 0;

  load(u.first, stage(0));
  swin::cp_async_commit();
  for (int img = u.first; img < u.last; ++img) {
    uint32_t* st = stage(stages == 2 ? (img - u.first) & 1 : 0);
    uint32_t* const q = st;
    const uint32_t* k = st + kNp * ldH;
    const uint32_t* v = st + 2 * kNp * ldH;
    swin::cp_async_wait<0>();
    __syncthreads();   // this sample has landed; every warp is done with the last one
    if (stages == 2 && img + 1 < u.last) {
      load(img + 1, stage((img + 1 - u.first) & 1));
      swin::cp_async_commit();
    }
    wattn::scale_rows<P>(q, ldH, m0, Hw, g.scale);

    // S = (scale q) k^T + bias and P = softmax(S), in this warp's fragments;
    // P, rounded to T, into the warp's rows of Ps
    {
      float p[kJt][4] = {};
      wattn::score_product<R, kJt>(p, q, k, ldH, m0, Hw);
      wattn::softmax_fragments(p, Bs, ldB, m0, n);
      wattn::store_rows<T>(Ps, ldP, p, m0);
    }
    __syncwarp();

    // O = P v: this warp's queries by the padded head dim
    float o[kMaxHt][4] = {};
#pragma unroll 1
    for (int kw = 0; kw < Kp; kw += 8) {
      uint32_t a[4], al[4], b[2];
      swin::frag_a(a, Ps, ldP, m0, kw);
      swin::split_a<R>(a, al);
#pragma unroll
      for (int jd = 0; jd < kMaxHt; ++jd) {
        if (jd >= ht) break;
        swin::frag_b_t<T>(b, v, ldH, 8 * jd, kw);
        swin::mma3<R>(o[jd], a, al, b[0], b[1]);
      }
    }
#pragma unroll
    for (int jd = 0; jd < kMaxHt; ++jd) {
      if (jd >= ht) break;
      swin::tile_pairs(o[jd], m0, 8 * jd, [&](int t, int d, float v0, float v1) {
        if (t >= n || d >= hd) return;
        T* dst = out + (static_cast<size_t>(img) * g.height * g.width + at[t]) * C + u.h * hd + d;
        if (paired) {
          swin::store2(dst, v0, v1);
        } else {
          dst[0] = swin::from_f32<T>(v0);
          if (d + 1 < hd) dst[1] = swin::from_f32<T>(v1);
        }
      });
    }
    if (stages == 1 && img + 1 < u.last) {
      __syncthreads();   // every warp is done with the one stage
      load(img + 1, stage(0));
      swin::cp_async_commit();
    }
  }
}

template <typename T, int NT>
int plan_of(int dtype, const Geometry& g, int (&plan)[5]) {
  return static_cast<int>(wattn::plan_for(
      window_attention_fwd_kernel<T, NT>, dtype, 32 * NT,
      smem_bytes(dtype, g.channels, g.heads, g.window, 1),
      smem_bytes(dtype, g.channels, g.heads, g.window, 2), g, plan));
}

template <typename T, int NT>
int launch(int dtype, const void* qkv, const float* bias, void* out, const Geometry& g,
           cudaStream_t stream) {
  int plan[5];
  const int err = plan_of<T, NT>(dtype, g, plan);
  if (err != 0) return err;
  window_attention_fwd_kernel<T, NT>
      <<<plan[0], 32 * NT, smem_bytes(dtype, g.channels, g.heads, g.window, plan[4]), stream>>>(
          static_cast<const T*>(qkv), bias, static_cast<T*>(out), g, plan[1], plan[4]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int dtype, const void* qkv, const float* bias, void* out, const Geometry& g,
           cudaStream_t stream) {
  if (wattn::warps_of(g.window * g.window) == 4)
    return launch<T, 4>(dtype, qkv, bias, out, g, stream);
  return launch<T, 6>(dtype, qkv, bias, out, g, stream);
}

}  // namespace

extern "C" {

// Shared memory one thread block needs at least (one stage), in bytes;
// dtype 0 float32, 1 bfloat16.
size_t window_attention_fwd_smem_bytes(int dtype, int channels, int heads, int window) {
  return smem_bytes(dtype, channels, heads, window, 1);
}

// The grid the launch uses: plan = {units, samples a unit, blocks an SM,
// SMs, stages}. Returns the cudaError_t (0 on success).
int window_attention_fwd_plan(int dtype, int batch, int height, int width, int channels,
                              int heads, int window, int* plan) {
  if (!wattn::takes(channels, heads, window) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{batch, height, width, channels, heads, window, 1, 1.f};
  int out[5];
  const bool wide = wattn::warps_of(window * window) == 6;
  const int err = dtype == 0 ? (wide ? plan_of<float, 6>(0, g, out) : plan_of<float, 4>(0, g, out))
                             : (wide ? plan_of<__nv_bfloat16, 6>(1, g, out)
                                     : plan_of<__nv_bfloat16, 4>(1, g, out));
  std::copy(out, out + 5, plan);
  return err;
}

// dtype: 0 float32, 1 bfloat16 (qkv and out); bias is float32
// (bias_windows, heads, n, n). Returns the cudaError_t (0 on success);
// cudaErrorInvalidValue past 96 tokens a window or 64 features a head.
int window_attention_fwd(int dtype, const void* qkv, const float* bias, void* out, int batch,
                         int height, int width, int channels, int heads, int window,
                         int bias_windows, float scale, void* stream) {
  if (!wattn::takes(channels, heads, window)) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{batch, height, width, channels, heads, window, bias_windows, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(0, qkv, bias, out, g, st);
  if (dtype == 1) return launch<__nv_bfloat16>(1, qkv, bias, out, g, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* window_attention_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
