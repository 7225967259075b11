// Fused multi-head attention for short protein contexts, hand-written for
// Hopper (sm_90a), with plain C entry points loaded through ctypes. The
// device code lives in grouped_attention.cuh (shared with the extent-sparse
// entry in seg_block_attention.cu); this file holds two entries.
//
// pgym_grouped_attention replaces
// proteingym_tpu/ops/flash_attention.py::_grouped_attention_kernel (the
// Pallas TPU kernel behind grouped_mha / mha for T <= 1024): q, k, v and out
// in (B, H, T, D) order of strides, with a key-padding mask, an (H, T) bias,
// segment ids, causal masking and fused RoPE.
//
// pgym_grouped_attention_bthd replaces ::_bthd_attention_kernel (behind
// grouped_mha_bthd / mha_natural): the same math read and written in the
// model's (B, T, H, D) layout, with no bias operand, as the TPU kernel takes
// none. The TPU kernel holds every head of a (batch row, query block) in
// one program's VMEM to avoid four HBM transposes around the call; here the
// layout is only a matter of strides, so the entry launches the same device
// code with (B, T, H, D) strides and nothing is transposed.
//
// What bounds it. At the ESM2-650M shape (B=16, H=20, T=256, D=64) a call
// moves 21 MB and does 5.4 GFLOP: ~6 us each at the H100's HBM and bf16
// tensor-core peaks, while the bf16 path takes ~0.13 ms. So neither bounds
// it; instruction issue and latency do. Every 64-query block restages every
// k/v tile (rotating k in float32 on the way), the softmax runs on the CUDA
// cores between the two tensor-core products, and four warps per block hide
// little latency. wgmma with TMA-fed shared-memory rings, warp
// specialisation and rotating k once per call are later work.

#include "grouped_attention.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: 12 int64 values, the (b, h, t)
// strides of q, k, v and out in that order. Returns the launch's
// cudaGetLastError() (0 on success); the launch does not synchronise.
int pgym_grouped_attention(const void* q, const void* k, const void* v,
                           void* out, const long long* strides, int B, int H,
                           int T, int D, int dtype,
                           const unsigned char* key_mask, const float* bias,
                           const int* seg, int causal, const float* cos_t,
                           const float* sin_t, float sm_scale, void* stream) {
  Params p = make_params(q, k, v, out, B, H, T, key_mask, seg, causal,
                         cos_t, sin_t, sm_scale);
  set_strides(p, strides);
  p.bias = bias;
  return (int)launch_grouped(p, D, dtype, static_cast<cudaStream_t>(stream));
}

// The (B, T, H, D) entry: strides are 12 int64 values, the (b, t, h) strides
// of q, k, v and out in that order. No bias. Otherwise as above.
int pgym_grouped_attention_bthd(const void* q, const void* k, const void* v,
                                void* out, const long long* strides, int B,
                                int H, int T, int D, int dtype,
                                const unsigned char* key_mask, const int* seg,
                                int causal, const float* cos_t,
                                const float* sin_t, float sm_scale,
                                void* stream) {
  long long bht[12];
  for (int x = 0; x < 4; ++x) {  // (b, t, h) -> (b, h, t)
    bht[3 * x] = strides[3 * x];
    bht[3 * x + 1] = strides[3 * x + 2];
    bht[3 * x + 2] = strides[3 * x + 1];
  }
  Params p = make_params(q, k, v, out, B, H, T, key_mask, seg, causal,
                         cos_t, sin_t, sm_scale);
  set_strides(p, bht);
  return (int)launch_grouped(p, D, dtype, static_cast<cudaStream_t>(stream));
}

const char* pgym_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
