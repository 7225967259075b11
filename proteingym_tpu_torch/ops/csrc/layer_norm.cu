// Layer norm over the last dim of bfloat16 rows, with an optional residual
// add fused in, hand-written for Hopper (sm_90a), with a plain C entry point
// loaded through ctypes.
//
// Replaces no TPU kernel. The JAX package's layer norm is plain jnp, which
// XLA fuses with its casts (and the residual add before it) into one pass
// over the activations. In eager PyTorch the same float32 math
// (esm2.LayerNorm's plain version) is a chain of passes: x.float() (2 B read
// and 4 B written per element), F.layer_norm (4 + 4), .to(bfloat16)
// (4 + 2), and before the second norm of each ESM layer the bf16 residual
// add (4 + 2): 20 B an element, 26 with the add. This kernel reads the bf16
// row once and writes the bf16 result once: 4 B an element, 8 with the add
// (x and delta in, their sum and its norm out).
//
// What it computes, for each row of width d:
//   s    = bf16(x + delta)                       (with delta: the bf16 add's
//                                                 rounding, written out)
//   mean = sum(s) / d,  var = sum((s - mean)^2) / d          (float32)
//   y    = bf16((s - mean) * rsqrt(var + eps) * weight + bias)
// with float32 weight and bias (s = x without delta). The sum is the bf16
// add bit for bit; y differs from F.layer_norm on the float32 copy only by
// the order of the float32 sums (within 1 bf16 ulp).
//
// What bounds it: bytes. At 32,768 rows x 1,280 the plain norm moves 168 MB
// (50 us at 3.35 TB/s), the fused one 336 MB (100 us). Design: a row stays
// in registers from its load to its store, so both reductions (the mean,
// then the centred sum of squares, which keeps float32's accuracy for rows
// with a large mean) cost no second read. A row belongs to a group of
// `warps` warps (1 up to d = 2,048, 2 up to 4,096, 3 at 5,120), each lane
// holding up to kMaxIters vectors of 8 bf16 moved by 16-byte loads and
// stores, so d is a multiple of 8 and every pointer 16-byte aligned (the
// wrapper's dispatch leaves other rows to the plain version); the sums go
// through warp shuffles and, across the row's warps, shared memory. Blocks hold about kBlockThreads threads, so
// short rows share a block. Weight and bias are read by every row and stay
// in L1 and L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kVec = 8;             // bf16 values a vector: 16 bytes
constexpr int kMaxIters = 8;        // vectors a lane holds
constexpr int kMaxThreads = 256;    // threads of a block (the launch bound)
constexpr int kMaxWarps = kMaxThreads / 32;  // warps of a row
constexpr int kBlockThreads = 128;  // rows are packed into blocks of about this many

struct Params {
  const __nv_bfloat16* x;
  const __nv_bfloat16* delta;  // null: no residual add
  const float* weight;
  const float* bias;
  __nv_bfloat16* y;
  __nv_bfloat16* sum;  // x + delta, written when delta is given
  long long rows;
  int d;
  int warps;  // warps of a row
  float eps;
};

__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p, float (&v)[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_bf16(__nv_bfloat16* p, const float (&v)[kVec]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void load_f32(const float* p, float (&v)[kVec]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// The sum of `v` over the row's `warps` warps, returned to every lane of
// them. `partial` holds one slot a warp of the block; each call site has its
// own, so no warp overwrites a slot another may still read.
__device__ __forceinline__ float row_sum(float v, float* partial, int warps) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (warps == 1) return v;  // uniform over the block: the barrier below is too
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) partial[warp] = v;
  __syncthreads();
  const int first = warp - warp % warps;
  float s = 0.f;
  for (int w = 0; w < warps; ++w) s += partial[first + w];
  return s;
}

template <int ITERS, bool ADD>
__global__ void __launch_bounds__(kMaxThreads) layer_norm_kernel(const Params p) {
  __shared__ float partial[2][kMaxThreads / 32];
  const int warp = threadIdx.x >> 5;
  const int rows_per_block = blockDim.x / (32 * p.warps);
  const long long row = (long long)blockIdx.x * rows_per_block + warp / p.warps;
  // rows past the end still take part in the block's barriers
  const bool live = row < p.rows;
  const int n_vec = p.d / kVec, stride = 32 * p.warps;
  const int first = (warp % p.warps) * 32 + (threadIdx.x & 31);
  const long long base = row * p.d;

  float v[ITERS][kVec];
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    const int c = first + i * stride;
    if (live && c < n_vec) {
      const long long at = base + (long long)c * kVec;
      load_bf16(p.x + at, v[i]);
      if constexpr (ADD) {
        float dv[kVec];
        load_bf16(p.delta + at, dv);
#pragma unroll
        for (int k = 0; k < kVec; ++k)
          v[i][k] = __bfloat162float(__float2bfloat16_rn(v[i][k] + dv[k]));
        store_bf16(p.sum + at, v[i]);  // exact: the values are bf16 already
      }
#pragma unroll
      for (int k = 0; k < kVec; ++k) acc += v[i][k];
    }
  }
  const float mean = row_sum(acc, partial[0], p.warps) / p.d;

  acc = 0.f;
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    if (live && first + i * stride < n_vec) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        v[i][k] -= mean;
        acc += v[i][k] * v[i][k];
      }
    }
  }
  const float rstd = rsqrtf(row_sum(acc, partial[1], p.warps) / p.d + p.eps);

#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    const int c = first + i * stride;
    if (live && c < n_vec) {
      float w[kVec], b[kVec];
      load_f32(p.weight + (long long)c * kVec, w);
      load_f32(p.bias + (long long)c * kVec, b);
#pragma unroll
      for (int k = 0; k < kVec; ++k) v[i][k] = v[i][k] * rstd * w[k] + b[k];
      store_bf16(p.y + base + (long long)c * kVec, v[i]);
    }
  }
}

// Launch the instance of ITERS == iters (1 .. kMaxIters).
template <bool ADD, int ITERS = 1>
void launch(int iters, dim3 grid, dim3 block, cudaStream_t stream, const Params& p) {
  if constexpr (ITERS <= kMaxIters) {
    if (iters == ITERS) {
      layer_norm_kernel<ITERS, ADD><<<grid, block, 0, stream>>>(p);
      return;
    }
    launch<ADD, ITERS + 1>(iters, grid, block, stream, p);
  }
}

bool aligned16(const void* ptr) {
  return ptr == nullptr || reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

extern "C" {

// x, delta, y, sum: contiguous (rows, d) bfloat16; weight, bias: (d,)
// float32; every pointer 16-byte aligned. delta and sum are both null (the
// norm of x) or both given (sum = x + delta, then its norm). Returns the
// launch's cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// arguments it does not take: d not a multiple of 8 or above 16,384, or a
// pointer not 16-byte aligned. Nothing synchronises.
int pgym_layer_norm(const void* x, const void* delta, const float* weight, const float* bias,
                    void* y, void* sum, long long rows, int d, float eps, void* stream) {
  if (rows < 0 || d <= 0 || d % kVec != 0 || (delta == nullptr) != (sum == nullptr) ||
      !(aligned16(x) && aligned16(delta) && aligned16(weight) && aligned16(bias) &&
        aligned16(y) && aligned16(sum)))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int n_vec = d / kVec;
  int warps = 1;
  while (warps <= kMaxWarps && (n_vec + 32 * warps - 1) / (32 * warps) > kMaxIters) ++warps;
  if (warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  const int iters = (n_vec + 32 * warps - 1) / (32 * warps);
  const int rows_per_block = kBlockThreads / (32 * warps) > 1 ? kBlockThreads / (32 * warps) : 1;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;

  const Params p{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(delta),
                 weight, bias, static_cast<__nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(sum),
                 rows, d, warps, eps};
  const dim3 grid((unsigned)blocks), block(32 * warps * rows_per_block);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (delta) launch<true>(iters, grid, block, s, p);
  else launch<false>(iters, grid, block, s, p);
  return (int)cudaGetLastError();
}

const char* pgym_layer_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
