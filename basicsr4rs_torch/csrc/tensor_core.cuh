// Tensor-core building blocks shared by the kernels that multiply on them
// (conv3x3_fwd.cu, swin_block_joint.cuh, branch_bwd.cuh): the TF32
// split, ldmatrix (plain and transposing), and the warp-wide mma.sync
// products of Hopper's (and Ampere's) tensor cores.
//
// Fragments, for lane l, g = l / 4 and t = l % 4, as 32-bit registers:
//   A (16 x K, row-major):  a0 (row g, word t), a1 (row g + 8, word t),
//                           a2 (row g, word t + 4), a3 (row g + 8, word t + 4)
//   B (K x 8, column-major): b0 (column g, word t), b1 (column g, word t + 4)
//   C (16 x 8, float32 or int32): c0, c1 (row g, columns 2t, 2t + 1),
//                                 c2, c3 (row g + 8, the same columns)
// where a word is one TF32 value (m16n8k8), two bfloat16 (m16n8k16) or four
// int8 (m16n8k32) of consecutive k, the lower k in the lower bits. So the
// three products read their operands in the same pattern of words.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tc {

// lane l receives, of each 8 x 8 b16 matrix whose rows lanes 8j .. 8j + 7
// address, the word l % 4 of row l / 4
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// The transposing loads: lane l receives, of each 8 x 8 b16 matrix whose
// rows lanes 8j .. 8j + 7 address, the word (row 2 (l % 4), row 2 (l % 4) + 1)
// of column l / 4, the lower row in the lower bits. For a matrix stored with
// its K index along the rows, that is the A or B fragment word of m16n8k16.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// float32 -> TF32, rounded to nearest (ties away), as a float's bits
__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// 3xTF32: v = hi + lo with hi = tf32(v), lo = tf32(v - hi); hi*hi + hi*lo +
// lo*hi keeps about 2^-21 of v*w where plain TF32 keeps 2^-11
__device__ __forceinline__ void split_tf32(uint32_t v, uint32_t& hi, uint32_t& lo) {
  const float f = __uint_as_float(v);
  hi = tf32(f);
  lo = tf32(f - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// int8 x int8 -> int32, exact (no saturation: |sum| < 2^31 for K < 2^17)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace tc
