// Device helpers shared by the attention kernels (grouped_attention.cu and
// flash_attention.cu): the tile size, the finite mask fill, bf16 rounding
// and vector loads, and the bf16 tensor-core product (mma.sync m16n8k16).
//
// Each .cu is its own translation unit and shared library, so everything
// here lives in an unnamed namespace. ops/_build.py hashes this header into
// the library name of every source that includes it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // queries per block == keys per shared-memory tile
constexpr float kNegInf = -1e30f;  // finite mask fill (NEG_INF in Python)

constexpr int kWarps = 4;  // bf16 path: 16 query rows each
constexpr int kMmaThreads = 32 * kWarps;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a (16x16, row-major) * b (16x8, column-major); bf16 in, float32 acc
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Launch `kernel` on a (B*H, ceil(T/kTile)) grid, raising the dynamic
// shared-memory limit first when the kernel needs more than 48 KB.
template <typename Kernel, typename P>
cudaError_t launch_tiles(Kernel kernel, const P& p, int threads, size_t smem,
                         cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(p.B * p.H, (p.T + kTile - 1) / kTile);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
