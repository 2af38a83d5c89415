// Deformable bilinear sampler, backward: from the cotangent of the column
// tensor, the gradients of the map, the offsets and the mask, in one pass.
//
// Replaces basicsr4rs_tpu/ops/dcn.py::_dcn_pallas_bwd_kernel. With x and
// the offsets as in deform_sample_fwd.cu, mask (N, G * K, Ho, Wo) or none
// and dcol (N, C, K, Ho, Wo) in x's type, one kernel writes
//
//   dx      (N, C, H, W)  float32: each sample's cotangent, times the mask,
//                         scattered to its four pixels with their blend
//                         weights;
//   doffset float32, in a layout of its own (for a flow the flow's): for dy
//                         the mask times the sum over the group's channels
//                         of dcol * ((1 - lx) * (v10 - v00) + lx * (v11 -
//                         v01)), and the like for dx: the one-sided
//                         difference at a whole position, zero where the
//                         sample is outside (-1, H) x (-1, W);
//   dmask   (N, G * K, Ho, Wo) float32: the sum over the group's channels of
//                         dcol times the unmodulated sample.
//
// The TPU kernel turns the scatter into products with hat-function matrices
// and keeps dx in an output block that stays resident while the grid walks a
// slab's pixel tiles in order. Here blocks run in no order and the scatter is
// the natural instruction, so the design is K8's grid with the sum of dx
// kept on the SM:
//
// - A block takes a tile of 32 x `rows` output pixels of one (sample,
//   deform group) (blockIdx.y) and the taps `taps_per_z` at a time
//   (blockIdx.z, split only as far as the card needs blocks). A thread takes
//   one pixel and walks its taps: each tap is located once (offsets through
//   OffsetLayout, the mask), then for each of the group's channels dcol is
//   read once (a warp reads a row of 32 pixels: coalesced) and the four
//   corners of x once (from L1: the group's maps near the tile), and from
//   those come d offset, d mask and the four dx shares. Where a group has
//   more than 8 channels its channels are split between `slices` warps of
//   the same pixel row (rows * slices = 8), whose partial sums of d offset
//   and d mask are added in shared memory in slice order.
// - dx is summed in a float32 window in shared memory, one per channel of
//   the group: the tile's footprint and `halo` pixels around it, placed
//   around the footprint moved by the block's centre, the mean offset of its
//   samples inside the map, rounded down (a block reduction first): for
//   BasicVSR++ the offsets are an optical flow plus a residue, so the samples
//   of a tile move together. Corners inside the window are added by shared
//   atomics; corners outside it (a large, scattered offset) go to dx in
//   device memory by atomicAdd, as part of the design. At the end the window
//   is added into dx once, by float4 reductions (red.global.add.v4.f32)
//   where the row's address is 16-byte aligned, skipping zero quads.
// - The host plans the window and the split (plan_of): the largest halo (up
//   to kMaxHalo) that keeps the blocks an SM of halo 0 as the card's
//   occupancy query gives them, kept per shape and device in a table of this
//   library.
//
// dx is a float32 buffer, zeroed on the stream by this call, whose sum's
// order changes from run to run: it does not repeat bit for bit. doffset and
// dmask have one writer each and do. The wrapper casts dx to x's type once.
//
// What bounds it on an H100: the bound is bytes (dcol, the largest operand,
// read once; offsets and mask read and their gradients written; x and dx
// once each), but the shared atomics set the pace: sm_90 has no shared
// float add, so each of the four a (sample, channel) is a compare-and-swap
// loop (ATOMS.CAST.SPIN), and where the offsets scatter a warp's corners
// over the window its lanes meet in banks and the loop takes several passes
// (at EDVR's training shape 0.36 of 0.66 ms with offsets of 2 px drawn per
// pixel, 0.13 of 0.41 ms with a smooth field). Measured and dropped: x's
// corners read from a copy of its window in shared memory (slower: half the
// halo at the same occupancy), the channels scattered in an order rotated
// by the lane, a row stride of 32 words. 64 registers a thread (4 blocks an
// SM, no spills): 48 (5 blocks, 60 bytes spilled) is 7% faster at EDVR's
// shapes and 7% slower at BasicVSR++'s single frame, the larger share of a
// step's K9 time.

#include <algorithm>
#include <array>
#include <map>
#include <mutex>

#include "deform_sample.cuh"

namespace {

using namespace dsample;

constexpr int kTileW = 32;                  // a warp: one row of 32 output pixels
constexpr int kLanes = kThreads / kTileW;   // rows x slices of a block: 8
constexpr int kMaxHalo = 8;
constexpr int kMinBlocks = 4;               // blocks an SM the registers allow (64 a thread)
constexpr int kStep = 2;                    // channels whose loads a thread issues together
constexpr float kFar = 16777216.f;          // the centre's clamp: keeps the window's ints small

// A block's share of the work and its window of dx, as the host plans them.
struct Window {
  int halo;            // pixels the window reaches past the tile's footprint on each side
  int slices;          // warps of one pixel row, each a share of the group's channels
  int rows;            // output rows of the tile: kLanes / slices
  int height, width;   // of the window in pixels, width a multiple of 4; 0 without dx
  int taps_per_z;      // taps of a block: blockIdx.z takes the next ones
  int vector;          // dx's rows are 16-byte aligned: the flush adds 4 floats at once
};

__device__ __forceinline__ bool inside_map(const Geometry& g, float py, float px) {
  return py > -1.f && py < static_cast<float>(g.height) && px > -1.f &&
         px < static_cast<float>(g.width);
}

// a corner's share of dx: into the window where it holds the corner, else
// into dx in device memory where the corner is in the map
__device__ __forceinline__ void add_share(bool in_window, bool in_map, float* w, float* d,
                                          float v) {
  if (in_window)
    atomicAdd(w, v);
  else if (in_map)
    atomicAdd(d, v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, bool kOneTap>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    deform_sample_bwd_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                             const float* __restrict__ mask, const T* __restrict__ dcol,
                             float* __restrict__ dx, float* __restrict__ doffset,
                             float* __restrict__ dmask, const Geometry g, const OffsetLayout o,
                             const OffsetLayout od, const Window wd,
                             unsigned long long* __restrict__ corners) {
  extern __shared__ __align__(16) float smem[];
  const int K = kOneTap ? 1 : taps(g);
  const int P = g.out_h * g.out_w, cpg = group_channels(g);
  const int tiles_w = (g.out_w + kTileW - 1) / kTileW;
  const int tile_y = blockIdx.x / tiles_w, tile_x = blockIdx.x - tile_y * tiles_w;
  const int warp = threadIdx.x / kTileW, lane = threadIdx.x % kTileW;
  const int slice = warp / wd.rows, row = warp - slice * wd.rows;
  const int ho = tile_y * wd.rows + row, wo = tile_x * kTileW + lane;
  const bool valid = ho < g.out_h && wo < g.out_w;
  const int pixel = valid ? ho * g.out_w + wo : 0;
  const int per_slice = (cpg + wd.slices - 1) / wd.slices;
  const int c_begin = min(cpg, slice * per_slice), c_end = min(cpg, c_begin + per_slice);
  const int k_begin = blockIdx.z * wd.taps_per_z, k_end = min(K, k_begin + wd.taps_per_z);
  const size_t plane = static_cast<size_t>(g.height) * g.width;
  const int cells = wd.height * wd.width;   // of one channel's window
  float* win = smem;                        // cpg * cells
  float* parts = smem + cpg * cells;        // 3 * kThreads: the slices' sums
  float* centre = parts + 3 * kThreads;     // 3 * kLanes: the warps' sums for the centre
  const bool want_dx = dx != nullptr, want_doffset = doffset != nullptr;
  unsigned long long near = 0, far = 0;     // corners summed in the window / in device memory
  const int items = g.batch * g.groups;
  for (int ng = blockIdx.y; ng < items; ng += gridDim.y) {   // n * G + grp
    const int n = ng / g.groups, grp = ng - n * g.groups;
    const int first = n * g.channels + grp * cpg;   // the group's first channel plane
    const int offsets_at = o.start + n * o.batch + pixel * o.pixel;
    // 1. the window: zeroed, and placed by the block's centre
    int oy = 0, ox = 0;
    if (want_dx) {
      float sy = 0.f, sx = 0.f, count = 0.f;
      if (valid && slice == 0) {
        for (int k = k_begin; k < k_end; ++k) {
          const int at = offsets_at + (grp * K + k) * o.tap;
          const int i = kOneTap ? 0 : k / g.kw, j = kOneTap ? 0 : k - i * g.kw;
          const float dy = offset[at], dxo = offset[at + o.pair];
          if (inside_map(g, static_cast<float>(ho * g.stride - g.pad + i * g.dil) + dy,
                         static_cast<float>(wo * g.stride - g.pad + j * g.dil) + dxo)) {
            sy += dy;
            sx += dxo;
            count += 1.f;
          }
        }
      }
      sy = warp_sum(sy);
      sx = warp_sum(sx);
      count = warp_sum(count);
      if (lane == 0) {
        centre[warp] = sy;
        centre[kLanes + warp] = sx;
        centre[2 * kLanes + warp] = count;
      }
      float4* w4 = reinterpret_cast<float4*>(win);
      for (int q = threadIdx.x; q < cpg * cells / 4; q += kThreads)
        w4[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      __syncthreads();
      float ty = 0.f, tx = 0.f, tc = 0.f;
#pragma unroll
      for (int w = 0; w < kLanes; ++w) {
        ty += centre[w];
        tx += centre[kLanes + w];
        tc += centre[2 * kLanes + w];
      }
      const float my = tc > 0.f ? floorf(ty / tc) : 0.f, mx = tc > 0.f ? floorf(tx / tc) : 0.f;
      const int cy = static_cast<int>(fminf(fmaxf(my, -kFar), kFar));
      const int cx = static_cast<int>(fminf(fmaxf(mx, -kFar), kFar));
      oy = tile_y * wd.rows * g.stride - g.pad + cy - wd.halo;
      ox = (tile_x * kTileW * g.stride - g.pad + cx - wd.halo) & ~3;   // down to a multiple of 4
    }
    // 2. the taps of the pixel, each located once, and the group's channels
    for (int k = k_begin; k < k_end; ++k) {
      float gy = 0.f, gx = 0.f, gm = 0.f, modulation = 0.f;
      if (valid) {
        const int at = offsets_at + (grp * K + k) * o.tap;
        const int i = kOneTap ? 0 : k / g.kw, j = kOneTap ? 0 : k - i * g.kw;
        const float py = static_cast<float>(ho * g.stride - g.pad + i * g.dil) + offset[at];
        const float px =
            static_cast<float>(wo * g.stride - g.pad + j * g.dil) + offset[at + o.pair];
        modulation = mask ? mask[static_cast<size_t>(ng * K + k) * P + pixel] : 1.f;
        if (inside_map(g, py, px)) {
          const float fy = floorf(py), fx = floorf(px);
          const int y0 = static_cast<int>(fy), x0 = static_cast<int>(fx);
          const float ly = py - fy, lx = px - fx;
          // the corners in the map, and those of them the window holds
          const bool top = y0 >= 0, bottom = y0 + 1 < g.height;
          const bool left = x0 >= 0, right = x0 + 1 < g.width;
          const bool f00 = top && left, f01 = top && right, f10 = bottom && left,
                     f11 = bottom && right;
          const int wy = y0 - oy, wx = x0 - ox;
          const bool r0 = wy >= 0 && wy < wd.height, r1 = wy + 1 >= 0 && wy + 1 < wd.height;
          const bool c0 = wx >= 0 && wx < wd.width, c1 = wx + 1 >= 0 && wx + 1 < wd.width;
          const bool s00 = f00 && r0 && c0, s01 = f01 && r0 && c1, s10 = f10 && r1 && c0,
                     s11 = f11 && r1 && c1;
          if (corners && slice == 0) {
            near += s00 + s01 + s10 + s11;
            far += (f00 && !s00) + (f01 && !s01) + (f10 && !s10) + (f11 && !s11);
          }
          const float w00 = (1.f - ly) * (1.f - lx), w01 = (1.f - ly) * lx;
          const float w10 = ly * (1.f - lx), w11 = ly * lx;
          const int corner = y0 * g.width + x0;   // may be negative: read only under a flag
          const int cell = wy * wd.width + wx;    // the same in the window
          for (int cb = c_begin; cb < c_end; cb += kStep) {
            float gv[kStep], v00[kStep], v01[kStep], v10[kStep], v11[kStep];
#pragma unroll
            for (int c = 0; c < kStep; ++c) {
              const bool on = cb + c < c_end;
              const size_t ch = static_cast<size_t>(first + cb + c);
              gv[c] = on ? to_f32(dcol[(ch * K + k) * P + pixel]) : 0.f;
              if (want_doffset) {
                const T* map = x + ch * plane;
                map += corner;
                v00[c] = on && f00 ? to_f32(map[0]) : 0.f;
                v01[c] = on && f01 ? to_f32(map[1]) : 0.f;
                v10[c] = on && f10 ? to_f32(map[g.width]) : 0.f;
                v11[c] = on && f11 ? to_f32(map[g.width + 1]) : 0.f;
              }
            }
#pragma unroll
            for (int c = 0; c < kStep; ++c) {
              if (cb + c >= c_end) break;
              if (want_doffset) {
                gy += gv[c] * ((1.f - lx) * (v10[c] - v00[c]) + lx * (v11[c] - v01[c]));
                gx += gv[c] * ((1.f - ly) * (v01[c] - v00[c]) + ly * (v11[c] - v10[c]));
                gm += gv[c] * ((1.f - ly) * ((1.f - lx) * v00[c] + lx * v01[c]) +
                               ly * ((1.f - lx) * v10[c] + lx * v11[c]));
              }
              if (want_dx) {
                const float share = gv[c] * modulation;
                float* w = win + (cb + c) * cells + cell;
                float* d = dx + static_cast<size_t>(first + cb + c) * plane;
                d += corner;
                add_share(s00, f00, w, d, share * w00);
                add_share(s01, f01, w + 1, d + 1, share * w01);
                add_share(s10, f10, w + wd.width, d + g.width, share * w10);
                add_share(s11, f11, w + wd.width + 1, d + g.width + 1, share * w11);
              }
            }
          }
        }
      }
      // 3. d offset and d mask of the tap: one writer each, the slices added in order
      if (want_doffset) {
        if (wd.slices > 1) {
          parts[threadIdx.x] = gy;
          parts[kThreads + threadIdx.x] = gx;
          parts[2 * kThreads + threadIdx.x] = gm;
          __syncthreads();
          if (slice == 0) {
            for (int s = 1; s < wd.slices; ++s) {
              const int t = threadIdx.x + s * wd.rows * kTileW;
              gy += parts[t];
              gx += parts[kThreads + t];
              gm += parts[2 * kThreads + t];
            }
          }
          __syncthreads();
        }
        if (valid && slice == 0) {
          const int back = od.start + n * od.batch + (grp * K + k) * od.tap + pixel * od.pixel;
          doffset[back] = gy * modulation;
          doffset[back + od.pair] = gx * modulation;
          if (dmask) dmask[static_cast<size_t>(ng * K + k) * P + pixel] = gm;
        }
      }
    }
    // 4. the window into dx: once, by float4 reductions where aligned
    if (want_dx) {
      __syncthreads();
      const int quads = wd.width / 4, channel_quads = cells / 4;
      for (int q = threadIdx.x; q < cpg * channel_quads; q += kThreads) {
        const float4 v = reinterpret_cast<const float4*>(win)[q];
        if (v.x == 0.f && v.y == 0.f && v.z == 0.f && v.w == 0.f) continue;
        const int c = q / channel_quads, r = (q - c * channel_quads) / quads;
        const int y = oy + r, xs = ox + 4 * (q - c * channel_quads - r * quads);
        if (y < 0 || y >= g.height) continue;   // no corner there: never reached
        float* d = dx + static_cast<size_t>(first + c) * plane + static_cast<size_t>(y) * g.width;
        if (wd.vector && xs >= 0 && xs + 3 < g.width) {
          atomicAdd(reinterpret_cast<float4*>(d + xs), v);
        } else {
          const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (e[i] != 0.f && xs + i >= 0 && xs + i < g.width) atomicAdd(d + xs + i, e[i]);
        }
      }
    }
    __syncthreads();   // the window and the centre's sums are free for the next (sample, group)
  }
  if (corners) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      near += __shfl_xor_sync(0xffffffffu, near, s);
      far += __shfl_xor_sync(0xffffffffu, far, s);
    }
    if (lane == 0) {
      atomicAdd(corners, near);
      atomicAdd(corners + 1, far);
    }
  }
}

// ------------------------------------------------------------------ the plan
int slices_for(int cpg) {
  int s = 1;
  while (s < kLanes && (cpg + s - 1) / s > 8) s *= 2;
  return s;
}

// The window of a halo: {height, width, shared bytes}; no window without dx.
std::array<int, 3> window_for(const Geometry& g, int slices, int halo, bool need_dx) {
  const int rows = kLanes / slices;
  const int span_y = (rows - 1) * g.stride + (g.kh - 1) * g.dil;
  const int span_x = (kTileW - 1) * g.stride + (g.kw - 1) * g.dil;
  // the bottom and right corners one past the span, and the left edge
  // rounded down to a multiple of 4
  const int h = need_dx ? span_y + 2 * halo + 2 : 0;
  const int w = need_dx ? (span_x + 2 * halo + 5 + 3) / 4 * 4 : 0;
  const long long floats = static_cast<long long>(group_channels(g)) * h * w + 3 * kThreads +
                           3 * kLanes;
  const long long bytes = floats * static_cast<long long>(sizeof(float));
  return {h, w, static_cast<int>(bytes < (1LL << 30) ? bytes : (1LL << 30))};
}

// plan: {halo, slices, rows, window height, window width, taps a block,
// grid x, grid y, grid z, blocks an SM, SMs, shared bytes a block}
using PlanArray = std::array<int, 12>;

// The plans by kernel, shape and device, and the dynamic shared memory each
// kernel was allowed on each device: one table for this library (in an
// unnamed namespace, so no other library shares it).
struct Plans {
  std::mutex lock;
  std::map<std::pair<const void*, std::array<int, 14>>, PlanArray> by_shape;
  std::map<std::pair<const void*, int>, int> allowed;
};

Plans& plans() {
  static Plans p;
  return p;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory on `device`,
// raising its limit only. The caller holds the lock.
cudaError_t allow(const void* kernel, int smem, int device) {
  int& now = plans().allowed[{kernel, device}];
  if (smem <= now) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) now = smem;
  return err;
}

// The window and the grid of a shape: the largest halo up to kMaxHalo whose
// window keeps the blocks an SM of halo 0 (which the registers and threads
// set, unless a group's channels fill the shared memory), and the taps split
// over blockIdx.z where that minimises waves x (taps a block + 1), a block's
// own work (centre, window, flush) counted as one tap more: BasicVSR++'s
// single frame (256 blocks of nine taps) runs in two halves, one wave.
template <typename T, bool kOneTap>
cudaError_t plan_of(int dtype, const Geometry& g, bool need_dx, PlanArray& plan) {
  const void* kernel = reinterpret_cast<const void*>(deform_sample_bwd_kernel<T, kOneTap>);
  int device = 0, sms = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::pair<const void*, std::array<int, 14>> key{
      kernel, {dtype, g.batch, g.channels, g.height, g.width, g.out_h, g.out_w, g.kh, g.kw,
               g.stride, g.pad, g.dil, g.groups, device * 2 + (need_dx ? 1 : 0)}};
  std::lock_guard<std::mutex> guard(plans().lock);
  const auto kept = plans().by_shape.find(key);
  if (kept != plans().by_shape.end()) {
    plan = kept->second;
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const int slices = slices_for(group_channels(g)), rows = kLanes / slices;
  int halo = -1, per_sm = 0;
  for (int h = 0; h <= (need_dx ? kMaxHalo : 0); ++h) {
    const int smem = window_for(g, slices, h, need_dx)[2];
    if (smem > limit) break;
    int per = 0;
    err = allow(kernel, smem, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (h == 0) per_sm = per;
    if (per == 0 || per < per_sm) break;
    halo = h;
  }
  if (halo < 0 || per_sm == 0) return cudaErrorInvalidConfiguration;
  const std::array<int, 3> window = window_for(g, slices, halo, need_dx);
  const int K = taps(g);
  const int tiles = ((g.out_w + kTileW - 1) / kTileW) * ((g.out_h + rows - 1) / rows);
  const int blocks_y = g.batch * g.groups < 65535 ? g.batch * g.groups : 65535;
  const long long blocks = static_cast<long long>(tiles) * blocks_y;
  const long long slots = static_cast<long long>(per_sm) * sms;
  int taps_per_z = K;
  long long best = -1;
  for (int split = 1; split <= K; ++split) {
    const int per = (K + split - 1) / split;
    if ((K + per - 1) / per != split) continue;   // the same blocks as a smaller split
    const long long cost = (blocks * split + slots - 1) / slots * (per + 1);
    if (best < 0 || cost < best) {
      best = cost;
      taps_per_z = per;
    }
  }
  plan = {halo, slices, rows, window[0], window[1], taps_per_z, tiles, blocks_y,
          (K + taps_per_z - 1) / taps_per_z, per_sm, sms, window[2]};
  plans().by_shape[key] = plan;
  return cudaSuccess;
}

cudaError_t plan_for(int dtype, const Geometry& g, bool need_dx, PlanArray& plan) {
  const bool one = taps(g) == 1;
  if (dtype == 0)
    return one ? plan_of<float, true>(0, g, need_dx, plan)
               : plan_of<float, false>(0, g, need_dx, plan);
  return one ? plan_of<__nv_bfloat16, true>(1, g, need_dx, plan)
             : plan_of<__nv_bfloat16, false>(1, g, need_dx, plan);
}

template <typename T, bool kOneTap>
cudaError_t launch(const void* x, const float* offset, const float* mask, const void* dcol,
                   float* dx, float* doffset, float* dmask, const Geometry& g,
                   const OffsetLayout& o, const OffsetLayout& od, const PlanArray& plan,
                   unsigned long long* corners, cudaStream_t stream) {
  const Window wd{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5],
                  g.width % 4 == 0 && reinterpret_cast<uintptr_t>(dx) % 16 == 0};
  deform_sample_bwd_kernel<T, kOneTap>
      <<<dim3(plan[6], plan[7], plan[8]), kThreads, plan[11], stream>>>(
          static_cast<const T*>(x), offset, mask, static_cast<const T*>(dcol), dx, doffset,
          dmask, g, o, od, wd, corners);
  return cudaGetLastError();
}

Geometry geometry_of(const int* dims) {
  return Geometry{dims[0], dims[1], dims[2], dims[3], dims[4],  dims[5],
                  dims[6], dims[7], dims[8], dims[9], dims[10], dims[11]};
}

bool takes(int dtype, const Geometry& g) {
  return (dtype == 0 || dtype == 1) && g.groups >= 1 && g.channels % g.groups == 0 &&
         g.kh >= 1 && g.kw >= 1 && g.stride >= 1 && g.dil >= 1;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (x and dcol); offset, mask and the three
// gradients are float32, mask (N, G * K, Ho, Wo) contiguous or null, and
// then dmask null. dx may be null (no gradient of the map wanted), and so
// may doffset (none of the offsets and the mask); dmask needs doffset. dims:
// batch, channels, height, width, out_h, out_w, kh, kw, stride, pad, dil,
// groups, the offset's layout (OffsetLayout: start, batch, tap, pair, pixel)
// and doffset's, one array. corners, when not null, gets the counts of
// corners summed in the window and in device memory added to its two
// unsigned 64-bit integers. The wrapper checks that x, dcol's channel planes
// and both layouts' reach index in 32 bits. Returns the cudaError_t.
int deform_sample_bwd(int dtype, const void* x, const float* offset, const float* mask,
                      const void* dcol, float* dx, float* doffset, float* dmask, const int* dims,
                      unsigned long long* corners, void* stream) {
  const Geometry g = geometry_of(dims);
  const OffsetLayout o{dims[12], dims[13], dims[14], dims[15], dims[16]};
  const OffsetLayout od{dims[17], dims[18], dims[19], dims[20], dims[21]};
  if (!takes(dtype, g) || (dmask && (!mask || !doffset)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dx) {
    const size_t bytes = static_cast<size_t>(g.batch) * g.channels * g.height * g.width *
                         sizeof(float);
    const cudaError_t err = cudaMemsetAsync(dx, 0, bytes, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if ((!dx && !doffset) || g.batch * g.groups == 0 || g.out_h * g.out_w == 0) return 0;
  PlanArray plan;
  cudaError_t err = plan_for(dtype, g, dx != nullptr, plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool one = taps(g) == 1;
  if (dtype == 0)
    err = one ? launch<float, true>(x, offset, mask, dcol, dx, doffset, dmask, g, o, od, plan,
                                    corners, st)
              : launch<float, false>(x, offset, mask, dcol, dx, doffset, dmask, g, o, od, plan,
                                     corners, st);
  else
    err = one ? launch<__nv_bfloat16, true>(x, offset, mask, dcol, dx, doffset, dmask, g, o, od,
                                            plan, corners, st)
              : launch<__nv_bfloat16, false>(x, offset, mask, dcol, dx, doffset, dmask, g, o,
                                             od, plan, corners, st);
  return static_cast<int>(err);
}

// The plan the launch would use on the current device for dims (as above;
// the layouts are not read) and whether dx is wanted: plan = {halo, slices,
// rows, window height, window width, taps a block, grid x, grid y, grid z,
// blocks an SM, SMs, shared bytes a block}. Returns the cudaError_t.
int deform_sample_bwd_plan(int dtype, const int* dims, int need_dx, int* plan) {
  const Geometry g = geometry_of(dims);
  if (!takes(dtype, g)) return static_cast<int>(cudaErrorInvalidValue);
  PlanArray out;
  const cudaError_t err = plan_for(dtype, g, need_dx != 0, out);
  if (err == cudaSuccess) std::copy(out.begin(), out.end(), plan);
  return static_cast<int>(err);
}

const char* deform_sample_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
