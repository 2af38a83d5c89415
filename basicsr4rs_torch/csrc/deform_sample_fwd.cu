// Deformable bilinear sampler, forward: the column tensor of a modulated
// deformable convolution, or, with one tap, a map warped by a flow.
//
// Replaces basicsr4rs_tpu/ops/dcn.py::_dcn_pallas_fwd_kernel. From x
// (N, C, H, W), offset (N, G * 2K, Ho, Wo) and an optional mask
// (N, G * K, Ho, Wo), both float32, it writes
//
//   col[n, c, k, ho, wo] = mask * bilinear(x[n, c], py, px)    (N, C, K, Ho, Wo)
//
// in x's type, blended in float32 (deform_sample.cuh has the positions and
// the border rule). (N, C * K, Ho * Wo) is the layout the convolution's GEMM
// with the weight (Cout, C * K) wants; with K = 1 it is the warped map.
//
// The TPU kernel keeps a zero-padded slab of the map in fast memory and
// turns the gather into two products with hat-function matrices, because
// that machine has a matrix unit and no gather. Here the gather is the
// natural instruction: a thread takes one (sample, deform group, channel
// chunk, tap, output pixel), derives the position once and reads the four
// neighbours of up to 8 channels straight from the NCHW map. Neighbouring
// threads take neighbouring output pixels, so the offset reads and the
// column writes are coalesced and the map reads nearly so while offsets are
// small. There is no padded copy, no slab and no tile size to choose.
//
// What bounds it on an H100: bytes. A sample is 4 reads (mostly from L1/L2),
// about 10 FLOP and one write, and the column tensor is K times the map: at
// C = 64, K = 9 on a 180 x 320 map of 5 frames the kernel must write 663 MB
// for 0.4 GFLOP of blending.

#include "deform_sample.cuh"

namespace {

using namespace dsample;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    deform_sample_fwd_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                             const float* __restrict__ mask, T* __restrict__ col,
                             const Geometry g, const long long items) {
  const int K = taps(g), P = g.out_h * g.out_w, cpg = group_channels(g), nchunk = chunks(g);
  const size_t plane = static_cast<size_t>(g.height) * g.width;
  for (long long item = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
       item < items; item += static_cast<long long>(gridDim.x) * kThreads) {
    long long rest = item;
    const int pixel = static_cast<int>(rest % P); rest /= P;
    const int k = static_cast<int>(rest % K); rest /= K;
    const int chunk = static_cast<int>(rest % nchunk); rest /= nchunk;
    const int grp = static_cast<int>(rest % g.groups);
    const int n = static_cast<int>(rest / g.groups);

    const Tap t = locate(g, offset, mask, n, grp, k, pixel);
    const float w00 = (1.f - t.ly) * (1.f - t.lx), w01 = (1.f - t.ly) * t.lx;
    const float w10 = t.ly * (1.f - t.lx), w11 = t.ly * t.lx;
    const int first = chunk * kChunk;
    const int last = first + kChunk < cpg ? first + kChunk : cpg;
    for (int j = first; j < last; ++j) {
      const size_t c = static_cast<size_t>(n) * g.channels + grp * cpg + j;
      float v = 0.f;
      if (t.inside) {
        float v00, v01, v10, v11;
        corners(x + c * plane, g, t, v00, v01, v10, v11);
        v = (w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11) * t.modulation;
      }
      col[(c * K + k) * P + pixel] = from_f32<T>(v);
    }
  }
}

template <typename T>
int launch(const void* x, const float* offset, const float* mask, void* col, const Geometry& g,
           cudaStream_t stream) {
  const long long items = static_cast<long long>(g.batch) * g.groups * chunks(g) * taps(g) *
                          g.out_h * g.out_w;
  if (items == 0) return 0;
  deform_sample_fwd_kernel<T><<<blocks_for(items), kThreads, 0, stream>>>(
      static_cast<const T*>(x), offset, mask, static_cast<T*>(col), g, items);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (x and col); offset and mask are float32,
// mask may be null. Returns the cudaError_t (0 on success).
int deform_sample_fwd(int dtype, const void* x, const float* offset, const float* mask, void* col,
                      int batch, int channels, int height, int width, int out_h, int out_w,
                      int kh, int kw, int stride, int pad, int dil, int groups, void* stream) {
  if (groups < 1 || channels % groups || kh < 1 || kw < 1 || stride < 1 || dil < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{batch, channels, height, width, out_h, out_w, kh, kw, stride, pad, dil, groups};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, offset, mask, col, g, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, offset, mask, col, g, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* deform_sample_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
