// Whole Swin transformer block, forward, with its four weight products in
// int8 (W8A8 serving), one thread block per window.
//
// Replaces basicsr4rs_tpu/ops/swin_block.py::_joint_int8_fwd_kernel (the
// Pallas kernel behind fused_swin_block_full(..., quant_int8=True)). The body
// is swin_block_joint.cuh's with kInt8 = true: qkv, proj, fc1 and fc2 are
// int8 x int8 -> int32 sums by __dp4a on weights quantised per output channel
// outside the kernel and activations quantised inside it, one dynamic scale
// per product and window (the tile this kernel holds; the TPU kernel's tile
// was a row of windows chosen for its VMEM).
//
// What bounds it on an H100: operations. The four products are 0.52 of the
// block's 0.56 M operations per token; as __dp4a they issue a quarter of the
// float kernel's instructions for them, at the CUDA cores' integer rate. The
// q.k and p.v products, LayerNorm, softmax, GELU and the four absmax and
// quantisation passes over the window stay float32 on the CUDA cores. Weights
// are 0.26 MB a block in int8 and stay in L2; device memory sees x in and
// out back. The int8 tensor cores (mma.sync s8) are later work.

#include "swin_block_joint.cuh"

extern "C" {

// Shared memory one thread block takes, in bytes.
size_t swin_block_joint_int8_fwd_smem_bytes(int channels, int heads, int hidden) {
  return swin::joint_smem_bytes(channels, heads, hidden, true);
}

// dtype of x and out: 0 float32, 1 bfloat16. wqkv, wproj, w1: int8 rows of
// round_up16(channels) values; w2: int8 rows of round_up16(hidden) values;
// sqkv, sproj, sw1, sw2: one float32 scale per row. quant_q, quant_s: null,
// or where the kernel also writes what it quantised (JointParams). Returns
// the cudaError_t of the launch (0 on success).
int swin_block_joint_int8_fwd(int dtype, const void* x, void* out, int batch, int height,
                              int width, int channels, int heads, int window, int hidden,
                              const float* ln1_w, const float* ln1_b, const void* wqkv,
                              const float* sqkv, const float* bqkv, const void* wproj,
                              const float* sproj, const float* bproj, const float* rel_bias,
                              const float* mask, const float* ln2_w, const float* ln2_b,
                              const void* w1, const float* sw1, const float* b1, const void* w2,
                              const float* sw2, const float* b2, float scale, void* quant_q,
                              float* quant_s, void* stream) {
  const swin::JointParams p{x,     out,   batch, height, width, channels, heads,    window,
                            hidden, ln1_w, ln1_b, wqkv,  bqkv,  wproj,    bproj,    rel_bias,
                            mask,  ln2_w, ln2_b, w1,     b1,    w2,       b2,       scale,
                            nullptr, nullptr, sqkv, sproj, sw1, sw2,
                            static_cast<int8_t*>(quant_q), quant_s};
  return swin::launch_joint<true>(dtype, p, stream);
}

const char* swin_block_joint_int8_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
