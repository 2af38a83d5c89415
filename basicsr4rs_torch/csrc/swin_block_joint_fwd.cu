// Whole Swin transformer block, forward, one thread block per window.
//
// Replaces basicsr4rs_tpu/ops/swin_block.py::_joint_fwd_kernel (the Pallas
// kernel behind fused_swin_block_full), with its optional per-sample DropPath
// scales s1, s2 (scaled=True there). The body is swin_block_joint.cuh's with
// kInt8 = false; swin_block_joint_int8_fwd.cu is its W8A8 twin.
//
// What bounds it on an H100: operations. A SwinIR-M block (C=180, 6 heads of
// 30, 8x8 windows, hidden 360) does 36.3 MFLOP a window against 2 x 46 KB of
// float32 x and out; the ~1 MB of float32 weights (0.5 MB bfloat16) stay in
// the 50 MB L2 and are read again by every window. Every product runs on
// the tensor cores by mma.sync (swin_block_joint.cuh: 3xTF32 in float32,
// m16n8k16 in bfloat16), every intermediate of a window stays in shared
// memory or registers, and the weights of each product stream from L2
// through two shared-memory stages by cp.async. 16 warps per window; the
// ~190 KB of shared memory (float32) allows one window per SM.

#include "swin_block_joint.cuh"

extern "C" {

// Shared memory one thread block of dtype (0 float32, 1 bfloat16) takes, in bytes.
size_t swin_block_joint_fwd_smem_bytes(int dtype, int channels, int heads) {
  return swin::joint_smem_bytes(dtype, channels, heads, 0, false);
}

// dtype: 0 float32, 1 bfloat16; s1, s2: (batch) float32 or both null.
// Returns the cudaError_t of the launch (0 on success).
int swin_block_joint_fwd(int dtype, const void* x, void* out, int batch, int height, int width,
                         int channels, int heads, int window, int hidden, const float* ln1_w,
                         const float* ln1_b, const void* wqkv, const float* bqkv,
                         const void* wproj, const float* bproj, const float* rel_bias,
                         const float* mask, const float* ln2_w, const float* ln2_b,
                         const void* w1, const float* b1, const void* w2, const float* b2,
                         const float* s1, const float* s2, float scale, void* stream) {
  const swin::JointParams p{x,     out,   batch, height, width, channels, heads,    window,
                            hidden, ln1_w, ln1_b, wqkv,  bqkv,  wproj,    bproj,    rel_bias,
                            mask,  ln2_w, ln2_b, w1,     b1,    w2,       b2,       scale,
                            s1,    s2,    nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  return swin::launch_joint<false>(dtype, p, stream);
}

const char* swin_block_joint_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
