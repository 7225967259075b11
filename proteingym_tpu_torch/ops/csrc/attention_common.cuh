// Device helpers shared by the attention code (grouped_attention.cu, its
// float32 kernel in grouped_attention.cuh and the Hopper loop in
// hopper_attention.cuh): the tile size, the finite mask fill, the state of
// a staged key, bf16 rounding and packing, vector loads and stores.
//
// Everything here lives in an unnamed namespace, so a source that includes
// it keeps its own copy. ops/_build.py hashes this header into the library
// name of every source that includes it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // keys per shared-memory tile of the Hopper loop
constexpr float kNegInf = -1e30f;  // finite mask fill (NEG_INF in Python)

// the state of one key of a staged tile: live, masked (the finite fill) or
// at or beyond T (no part at all)
enum KeyState { kLive = 0, kMasked = 1, kBeyondT = 2 };

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// N consecutive bf16 values as one 16-byte (N=8) or 8-byte (N=4) access;
// the wrapper guarantees the alignment
template <int N>
struct BfVec;
template <>
struct BfVec<8> { using type = uint4; };
template <>
struct BfVec<4> { using type = uint2; };

template <int N>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* src, float* dst) {
  const typename BfVec<N>::type raw =
      *reinterpret_cast<const typename BfVec<N>::type*>(src);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

template <int N>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* dst, const float* src) {
  typename BfVec<N>::type raw;
  __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    pairs[i] = __floats2bfloat162_rn(src[2 * i], src[2 * i + 1]);
  *reinterpret_cast<typename BfVec<N>::type*>(dst) = raw;
}

}  // namespace
