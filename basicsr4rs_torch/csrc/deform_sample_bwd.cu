// Deformable bilinear sampler, backward: from the cotangent of the column
// tensor, the gradients of the map, the offsets and the mask.
//
// Replaces basicsr4rs_tpu/ops/dcn.py::_dcn_pallas_bwd_kernel. With x, offset
// and mask as in deform_sample_fwd.cu and dcol (N, C, K, Ho, Wo) in x's type,
// two kernels behind one C function write
//
//   dx      (N, C, H, W)        float32: each sample's cotangent, times the
//                               mask, scattered to its four pixels with
//                               their blend weights;
//   doffset (N, G * 2K, Ho, Wo) float32: for dy, the mask times the sum over
//                               the group's channels of dcol * ((1 - lx) *
//                               (v10 - v00) + lx * (v11 - v01)), and the
//                               like for dx: the one-sided difference at a
//                               whole position, zero where the sample is
//                               outside (-1, H) x (-1, W);
//   dmask   (N, G * K, Ho, Wo)  float32: the sum over the group's channels
//                               of dcol times the unmodulated sample.
//
// The TPU kernel accumulates dx in an output block that stays resident
// while the grid walks one slab's pixel tiles in order. Blocks here run in
// no order, so dx is a float32 buffer, zeroed on the stream, that threads
// add to with atomicAdd: the sum's order changes from run to run and dx does
// not repeat bit for bit. doffset and dmask have one writer each and do
// repeat. The wrapper casts dx to x's type once, after the sum.
//
// What bounds it on an H100: bytes (dcol read twice, x gathered twice, dx
// written through atomics), as in the forward. The dx kernel splits a
// group's channels into chunks of 8 for parallelism at one tap; the offset
// kernel walks all of a group's channels in one thread so that each
// gradient has one writer.

#include "deform_sample.cuh"

namespace {

using namespace dsample;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    deform_sample_dx_kernel(const float* __restrict__ offset, const float* __restrict__ mask,
                            const T* __restrict__ dcol, float* __restrict__ dx, const Geometry g,
                            const long long items) {
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
    if (!t.inside) continue;
    const float w00 = (1.f - t.ly) * (1.f - t.lx), w01 = (1.f - t.ly) * t.lx;
    const float w10 = t.ly * (1.f - t.lx), w11 = t.ly * t.lx;
    const int first = chunk * kChunk;
    const int last = first + kChunk < cpg ? first + kChunk : cpg;
    for (int j = first; j < last; ++j) {
      const size_t c = static_cast<size_t>(n) * g.channels + grp * cpg + j;
      const float grad = to_f32(dcol[(c * K + k) * P + pixel]) * t.modulation;
      float* row0 = dx + c * plane + static_cast<ptrdiff_t>(t.y0) * g.width + t.x0;
      float* row1 = row0 + g.width;
      if (t.top && t.left) atomicAdd(row0, grad * w00);
      if (t.top && t.right) atomicAdd(row0 + 1, grad * w01);
      if (t.bottom && t.left) atomicAdd(row1, grad * w10);
      if (t.bottom && t.right) atomicAdd(row1 + 1, grad * w11);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    deform_sample_doffset_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                                 const float* __restrict__ mask, const T* __restrict__ dcol,
                                 float* __restrict__ doffset, float* __restrict__ dmask,
                                 const Geometry g, const long long items) {
  const int K = taps(g), P = g.out_h * g.out_w, cpg = group_channels(g);
  const size_t plane = static_cast<size_t>(g.height) * g.width;
  for (long long item = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
       item < items; item += static_cast<long long>(gridDim.x) * kThreads) {
    long long rest = item;
    const int pixel = static_cast<int>(rest % P); rest /= P;
    const int k = static_cast<int>(rest % K); rest /= K;
    const int grp = static_cast<int>(rest % g.groups);
    const int n = static_cast<int>(rest / g.groups);

    const Tap t = locate(g, offset, mask, n, grp, k, pixel);
    float dpy = 0.f, dpx = 0.f, dm = 0.f;
    if (t.inside) {
      for (int j = 0; j < cpg; ++j) {
        const size_t c = static_cast<size_t>(n) * g.channels + grp * cpg + j;
        const float grad = to_f32(dcol[(c * K + k) * P + pixel]);
        float v00, v01, v10, v11;
        corners(x + c * plane, g, t, v00, v01, v10, v11);
        dpy += grad * ((1.f - t.lx) * (v10 - v00) + t.lx * (v11 - v01));
        dpx += grad * ((1.f - t.ly) * (v01 - v00) + t.ly * (v11 - v10));
        dm += grad * ((1.f - t.ly) * ((1.f - t.lx) * v00 + t.lx * v01) +
                      t.ly * ((1.f - t.lx) * v10 + t.lx * v11));
      }
    }
    doffset[t.offset_at] = dpy * t.modulation;
    doffset[t.offset_at + P] = dpx * t.modulation;
    if (dmask) dmask[t.mask_at] = dm;
  }
}

template <typename T>
int launch(const void* x, const float* offset, const float* mask, const void* dcol, float* dx,
           float* doffset, float* dmask, const Geometry& g, cudaStream_t stream) {
  const long long taps_total = static_cast<long long>(g.batch) * g.groups * taps(g) *
                               g.out_h * g.out_w;
  if (dx) {
    const size_t bytes = static_cast<size_t>(g.batch) * g.channels * g.height * g.width *
                         sizeof(float);
    cudaError_t err = cudaMemsetAsync(dx, 0, bytes, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long items = taps_total * chunks(g);
    if (items > 0) {
      deform_sample_dx_kernel<T><<<blocks_for(items), kThreads, 0, stream>>>(
          offset, mask, static_cast<const T*>(dcol), dx, g, items);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  if (doffset && taps_total > 0) {
    deform_sample_doffset_kernel<T><<<blocks_for(taps_total), kThreads, 0, stream>>>(
        static_cast<const T*>(x), offset, mask, static_cast<const T*>(dcol), doffset, dmask, g,
        taps_total);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (x and dcol); offset, mask and the three
// gradients are float32. mask may be null, and then dmask must be. dx may be
// null (no gradient of the map wanted), and so may doffset (none of the
// offsets and the mask); dmask needs doffset. Returns the cudaError_t.
int deform_sample_bwd(int dtype, const void* x, const float* offset, const float* mask,
                      const void* dcol, float* dx, float* doffset, float* dmask, int batch,
                      int channels, int height, int width, int out_h, int out_w, int kh, int kw,
                      int stride, int pad, int dil, int groups, void* stream) {
  if (groups < 1 || channels % groups || kh < 1 || kw < 1 || stride < 1 || dil < 1 ||
      (dmask && (!mask || !doffset)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{batch, channels, height, width, out_h, out_w, kh, kw, stride, pad, dil, groups};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, offset, mask, dcol, dx, doffset, dmask, g, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, offset, mask, dcol, dx, doffset, dmask, g, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* deform_sample_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
