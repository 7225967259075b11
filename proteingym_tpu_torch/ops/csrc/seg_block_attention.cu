// Extent-sparse block-diagonal attention for segment-packed rows,
// hand-written for Hopper (sm_90a), with a plain C entry point loaded
// through ctypes.
//
// Replaces: proteingym_tpu/ops/flash_attention.py::_seg_block_kernel (the
// Pallas TPU kernel behind seg_block_mha, which mha reaches for rows longer
// than 1024 tokens with segment ids, no bias and no causal mask). It
// computes what that kernel computes: for each (batch, head, query tile),
// softmax over the same-segment keys of the key tiles [lo, hi) that share a
// segment with the tile's queries, times v, with an online softmax (the
// same-segment select before the row max, the finite -1e30 fill,
// normalisation deferred to the output with the denominator floored at
// 1e-30). Segment ids are (B, T) int32, contiguous runs, 0 = padding; a
// live query sees exactly its own segment, so its output equals dense
// segmented attention. Padding queries see the padding run in their
// extent: unconsumed garbage, as in the TPU kernel.
//
// What bounds it. A packed row holds many short independent segments, so
// dense segmented attention (the grouped kernel) spends most of its
// tensor-core products on key tiles that the segment mask zeroes. With
// extents the work per (b, h) is 4 * D * 64^2 FLOP per visited (query tile,
// key tile) pair: ~sum_s L_s^2 instead of T^2. At B=8, H=20, T=4096, D=64
// with 16 segments of 250 tokens a query tile visits ~6 of 64 key tiles:
// ~65 GFLOP of products instead of ~690. The kernel is bound by those
// tensor-core FLOPs over the visited tiles, issued at the grouped kernel's
// rate (mma.sync, not wgmma).
//
// Design. The TPU kernel's 128-edge blocks, head groups and scalar-prefetched
// extent tables are TPU choices. Here one thread block per (batch*head,
// 64-query tile) reads its own [lo, hi) from the (B, ceil(T/64)) extent
// arrays (computed on the device by the wrapper at this kernel's tile edge)
// and loops over those key tiles only; tiles outside the extents are never
// loaded. The device code is the grouped kernel's (grouped_attention.cuh):
// the same staging, mma.sync bf16 products with float32 accumulation, the
// scalar float32 path for float32 inputs, (B, H, T, D) strides so the
// model's (B, T, H, D) projections are read in place, and no cap on T (a
// ragged last tile is masked in the kernel). There is no key mask operand:
// callers fold it into the segment ids (masked keys join segment 0).
//
// Rounding order. RoPE is fused on load, as in the grouped kernel: q is
// scaled in float32 and rounded to the input type, then rotated in float32
// and rounded again; k is rotated and rounded. The plain version rotates
// first and then scales (the JAX wrapper's order). The two agree exactly
// when sm_scale is 1 (ESM pre-scales q) and within one bf16 rounding of q
// otherwise.

#include "grouped_attention.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: 12 int64 values, the (b, h, t)
// strides of q, k, v and out in that order. seg: (B, T) int32. kt_lo, kt_hi:
// (B, n_qt) int32 key-tile extents of each 64-query tile, n_qt >=
// ceil(T / 64). Returns the launch's cudaGetLastError() (0 on success); the
// launch does not synchronise.
int pgym_seg_block_attention(const void* q, const void* k, const void* v,
                             void* out, const long long* strides, int B,
                             int H, int T, int D, int dtype, const int* seg,
                             const int* kt_lo, const int* kt_hi, int n_qt,
                             const float* cos_t, const float* sin_t,
                             float sm_scale, void* stream) {
  if (seg == nullptr || kt_lo == nullptr || kt_hi == nullptr ||
      n_qt < (T + kTile - 1) / kTile)
    return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, out, B, H, T, nullptr, seg, 0, cos_t, sin_t,
                         sm_scale);
  set_strides(p, strides);
  p.kt_lo = kt_lo;
  p.kt_hi = kt_hi;
  p.n_qt = n_qt;
  return (int)launch_grouped(p, D, dtype, static_cast<cudaStream_t>(stream));
}

const char* pgym_seg_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
