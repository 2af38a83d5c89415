// Deformable bilinear sampler, forward: the column tensor of a modulated
// deformable convolution, or, with one tap, a map warped by a flow.
//
// Replaces basicsr4rs_tpu/ops/dcn.py::_dcn_pallas_fwd_kernel. From x
// (N, C, H, W), float32 offsets and an optional float32 mask
// (N, G * K, Ho, Wo), it writes
//
//   col[n, c, k, ho, wo] = mask * bilinear(x[n, c], py, px)    (N, C, K, Ho, Wo)
//
// in x's type, blended in float32 (deform_sample.cuh has the positions and
// the border rule). (N, C * K, Ho * Wo) is the layout the convolution's GEMM
// with the weight (Cout, C * K) wants; with K = 1 it is the warped map.
//
// The offsets are read through strides (OffsetLayout): the (dy, dx) pair of
// sample n, deform group g, tap k and output pixel p = ho * Wo + wo has dy
// at start + n * batch + (g * K + k) * tap + p * pixel and dx `pair`
// elements from it. BasicSR's offset (N, G * 2K, Ho, Wo) is (0, G * 2K * P,
// 2P, P, 1); a flow (N, H, W, 2) with last dimension (dx, dy), in any
// strides whose pixels flatten, is (s_c, s_n, 0, -s_c, s_w), so flow_warp
// hands it over as it is and the position is base + flow in one rounding.
//
// The TPU kernel keeps a zero-padded slab of the map in fast memory and
// turns the gather into two products with hat-function matrices, because
// that machine has a matrix unit and no gather. Here the gather is the
// natural instruction. The grid is (tiles of 32 x 8 output pixels, sample x
// deform group, taps and channel chunks): a thread decodes its item with 32-bit
// arithmetic once (the wrapper checks the sizes; addresses are 64-bit),
// walks the taps of its pixel (their corner reads of the group's maps then
// come from the block's L1, not once a tap from L2), derives each tap's
// position, corner flags and blend weights once, and walks the group's
// channels 8 at a time, unrolled: the 32 corner loads of a chunk are issued
// together, then blended and stored. A warp takes a row of 32 output pixels,
// so offset reads and column writes are coalesced and map reads nearly so
// while offsets are small, and a block's 32 x 8 tile keeps the part of the
// maps its taps read small enough for L1 on wide frames. Taps, then channel chunks, are
// split over blockIdx.z only as far as the card needs blocks (BasicVSR++'s
// single frame, a one-tap warp of a 64-channel map on a small frame).
//
// What bounds it on an H100: bytes. A sample is 4 reads (mostly from L1/L2),
// about 10 FLOP and one write, and the column tensor is K times the map: at
// C = 64, K = 9 on a 180 x 320 map of 5 frames the kernel must write 663 MB
// for 0.4 GFLOP of blending.

#include "deform_sample.cuh"

namespace {

using namespace dsample;

struct OffsetLayout {
  int start, batch, tap, pair, pixel;   // in float32 elements
};

// a block's output pixels: a warp is one row of 32, its stores 128-byte lines
constexpr int kTileW = 32, kTileH = kThreads / kTileW;

// How the taps and the channel chunks of a (sample, group) are split over
// blockIdx.z: z = zk * nz_chunks + zc takes taps [zk * taps_per_z, ...) and
// chunks [zc * chunks_per_z, ...).
struct Split {
  int nz_chunks, taps_per_z, chunks_per_z;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    deform_sample_fwd_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                             const float* __restrict__ mask, T* __restrict__ col,
                             const Geometry g, const OffsetLayout o, const Split z) {
  const int P = g.out_h * g.out_w;
  const int tiles_w = (g.out_w + kTileW - 1) / kTileW;
  const int tile_y = blockIdx.x / tiles_w, tile_x = blockIdx.x - tile_y * tiles_w;
  const int ho = tile_y * kTileH + threadIdx.x / kTileW;
  const int wo = tile_x * kTileW + threadIdx.x % kTileW;
  if (ho >= g.out_h || wo >= g.out_w) return;
  const int pixel = ho * g.out_w + wo;
  const int K = taps(g), cpg = group_channels(g);
  const int zk = blockIdx.z / z.nz_chunks, zc = blockIdx.z - zk * z.nz_chunks;
  const int k_begin = zk * z.taps_per_z, k_end = min(K, k_begin + z.taps_per_z);
  const int c_begin = zc * z.chunks_per_z * kChunk;
  const int c_end = min(cpg, c_begin + z.chunks_per_z * kChunk);
  const int items = g.batch * g.groups;
  const size_t plane = static_cast<size_t>(g.height) * g.width;
  for (int ng = blockIdx.y; ng < items; ng += gridDim.y) {   // n * G + grp
    const int n = ng / g.groups, grp = ng - n * g.groups;
    const int first = n * g.channels + grp * cpg;   // the group's first channel plane
    // the taps of a pixel in one thread, so that their corner reads of the
    // group's maps come from the block's L1
    for (int k = k_begin; k < k_end; ++k) {
      const int at = o.start + n * o.batch + (grp * K + k) * o.tap + pixel * o.pixel;
      const int i = k / g.kw, j = k - i * g.kw;
      const float py = static_cast<float>(ho * g.stride - g.pad + i * g.dil) + offset[at];
      const float px =
          static_cast<float>(wo * g.stride - g.pad + j * g.dil) + offset[at + o.pair];
      const float modulation = mask ? mask[static_cast<size_t>(ng * K + k) * P + pixel] : 1.f;
      const bool inside = py > -1.f && py < static_cast<float>(g.height) && px > -1.f &&
                          px < static_cast<float>(g.width);
      const float fy = floorf(py), fx = floorf(px);
      const int y0 = static_cast<int>(fy), x0 = static_cast<int>(fx);
      const float ly = py - fy, lx = px - fx;
      const float w00 = (1.f - ly) * (1.f - lx), w01 = (1.f - ly) * lx;
      const float w10 = ly * (1.f - lx), w11 = ly * lx;
      // the corners in the map; none where the sample is zero
      const bool top = inside && y0 >= 0, bottom = inside && y0 + 1 < g.height;
      const bool left = x0 >= 0, right = x0 + 1 < g.width;
      const bool f00 = top && left, f01 = top && right, f10 = bottom && left,
                 f11 = bottom && right;
      const int corner = y0 * g.width + x0;   // may be negative: read only under a flag
      for (int c0 = c_begin; c0 < c_end; c0 += kChunk) {
        float v00[kChunk], v01[kChunk], v10[kChunk], v11[kChunk];
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const bool on = c0 + c < c_end;
          const T* map = x + static_cast<size_t>(first + c0 + c) * plane + corner;
          v00[c] = on && f00 ? to_f32(map[0]) : 0.f;
          v01[c] = on && f01 ? to_f32(map[1]) : 0.f;
          v10[c] = on && f10 ? to_f32(map[g.width]) : 0.f;
          v11[c] = on && f11 ? to_f32(map[g.width + 1]) : 0.f;
        }
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          if (c0 + c >= c_end) break;
          const float v = inside ? (w00 * v00[c] + w01 * v01[c] + w10 * v10[c] + w11 * v11[c]) *
                                       modulation
                                 : 0.f;
          col[static_cast<size_t>((first + c0 + c) * K + k) * P + pixel] = from_f32<T>(v);
        }
      }
    }
  }
}

int multiprocessors() {
  static const int count = [] {
    int device = 0, n = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    return n > 0 ? n : 132;
  }();
  return count;
}

template <typename T>
int launch(const void* x, const float* offset, const float* mask, void* col, const Geometry& g,
           const OffsetLayout& o, cudaStream_t stream) {
  const int P = g.out_h * g.out_w, items = g.batch * g.groups, K = taps(g);
  if (P == 0 || items == 0 || g.channels == 0) return 0;
  const int blocks_x = ((g.out_w + kTileW - 1) / kTileW) * ((g.out_h + kTileH - 1) / kTileH);
  const int blocks_y = items < 65535 ? items : 65535;
  // split the taps, then the channel chunks, over blockIdx.z only until
  // there are 4 blocks an SM
  const int nchunk = chunks(g);
  const long long blocks = static_cast<long long>(blocks_x) * blocks_y;
  long long want = (4LL * multiprocessors() + blocks - 1) / blocks;
  const int nz_taps = static_cast<int>(want < K ? want : K);
  const int taps_per_z = (K + nz_taps - 1) / nz_taps;
  want = (want + nz_taps - 1) / nz_taps;
  const int nz_chunks = static_cast<int>(want < nchunk ? want : nchunk);
  const int chunks_per_z = (nchunk + nz_chunks - 1) / nz_chunks;
  const Split z{(nchunk + chunks_per_z - 1) / chunks_per_z, taps_per_z, chunks_per_z};
  const dim3 grid(blocks_x, blocks_y, ((K + taps_per_z - 1) / taps_per_z) * z.nz_chunks);
  deform_sample_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), offset, mask, static_cast<T*>(col), g, o, z);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (x and col); offset and mask are float32,
// mask may be null and is (N, G * K, Ho, Wo) contiguous. dims: batch,
// channels, height, width, out_h, out_w, kh, kw, stride, pad, dil, groups,
// then the offset's layout (OffsetLayout: start, batch, tap, pair, pixel),
// one array so that a launch passes few arguments. The wrapper checks that
// x, the channel planes of col and the offset's reach index in 32 bits.
// Returns the cudaError_t (0 on success).
int deform_sample_fwd(int dtype, const void* x, const float* offset, const float* mask, void* col,
                      const int* dims, void* stream) {
  const Geometry g{dims[0], dims[1], dims[2], dims[3], dims[4],  dims[5],
                   dims[6], dims[7], dims[8], dims[9], dims[10], dims[11]};
  const OffsetLayout o{dims[12], dims[13], dims[14], dims[15], dims[16]};
  if (g.groups < 1 || g.channels % g.groups || g.kh < 1 || g.kw < 1 || g.stride < 1 || g.dil < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, offset, mask, col, g, o, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, offset, mask, col, g, o, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* deform_sample_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
