// Long-context fused multi-head attention, hand-written for Hopper
// (sm_90a), with a plain C entry point loaded through ctypes.
//
// Replaces: proteingym_tpu/ops/flash_attention.py::_attention_kernel (the
// Pallas TPU kernel behind flash_mha, which the mha dispatcher takes for
// T > 1024 without segments: PoET's multi tier, causal attention over a
// whole sequence-of-sequences row). It computes what that kernel computes:
// out = softmax(q.k^T + key_bias [causal]) . v per (batch, head), with
//   - one additive float32 key-bias row per (batch, head), folded by the
//     wrapper from the key-padding mask (-1e30 at masked keys) and an
//     optional (H, T) bias (ALiBi); the kernel reads it through (batch,
//     head) strides, so a row shared by all heads is stored once;
//   - causal masking (future keys take the finite fill -1e30);
//   - the softmax scale folded into q on load, rounded to the input type,
//     as the JAX wrapper folds it.
// There is no RoPE inside: the caller rotates q/k first.
//
// Design. The TPU kernel holds the full-T K/V rows of a head and a
// (block_q, T) float32 score block in VMEM. This kernel streams instead
// (FlashAttention-2's scheme, as the short-context grouped_attention.cu
// does): one thread block per (batch*head, 64-query tile), a loop over
// 64-key tiles staged in shared memory, an online softmax with float32
// running max, denominator and accumulator, and the normalisation deferred
// to the output: acc / max(denom, 1e-30), cast to the input type.
//
//   Causal calls visit only the key tiles up to the block's diagonal tile,
//   about half the work at long T; the blocks with most tiles are numbered
//   first, so they start first. A query row whose visited keys are all
//   masked (its running max is still the fill) averages v over all T keys
//   in the plain version, the future keys included; a block holding such a
//   row therefore goes on through the remaining tiles, where every key of
//   that row takes the fill too. Rows with a live key are unchanged by
//   those tiles: exp(-1e30 - max) is 0.
//
//   bfloat16: four warps, 16 query rows each; q.k^T and p.v on the tensor
//     cores (mma.sync m16n8k16, bf16 operands, float32 accumulation); k is
//     staged with 16-byte copies, v transposed; p is rounded to bf16 for
//     the p.v product, as the TPU kernel does. Head dims that are not a
//     multiple of 16 (24) are zero-padded to 32 in shared memory.
//   float32: one thread per query row with scalar float32 FMAs.
//
// What bounds it. At PoET's multi-tier shape (B=8, H=16, T=4352, D=64,
// causal) a call does 2 * 2 * B*H*T^2*D / 2 = 310 GFLOP of useful products
// (0.31 ms at the bf16 tensor-core peak) and moves 285 MB of q/k/v/out
// (0.09 ms at the HBM peak), so it is compute-bound in principle. In this
// first version instruction throughput and latency limit it: each block
// restages every visited k/v tile with no overlap of copies and products
// (no cp.async or TMA rings), the softmax runs on the CUDA cores between
// the two products, and mma.sync reaches a fraction of what wgmma would.
//
// Layout. q, k, v and out come with their batch, head and token strides (in
// elements, (B, H, T, D) order); the head-dim stride must be 1.

#include <math.h>

#include "attention_common.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sq[3], sk[3], sv[3], so[3];  // b, h, t strides in elements
  const float* kbias;                    // key-bias rows, or null (no bias)
  long long kb_b, kb_h;                  // their batch and head strides
  float sm_scale;
  int B, H, T;
  int causal;
};

// key bias of the tile starting at k0, one key per thread tid < kTile
__device__ __forceinline__ void load_key_bias(const Params& p, int b, int h,
                                              int k0, int tid, float* kb) {
  if (tid >= kTile) return;
  const int kj = k0 + tid;
  kb[tid] = (p.kbias != nullptr && kj < p.T)
                ? p.kbias[b * p.kb_b + h * p.kb_h + kj]
                : 0.0f;
}

// the score of (query qi, key kj) after the bias and the causal mask; keys
// beyond T take -inf and no part at all
__device__ __forceinline__ float masked_score(const Params& p, float s,
                                              float kb, int kj, int qi) {
  s += kb;
  if (p.causal && kj > qi) s = kNegInf;
  if (kj >= p.T) s = -INFINITY;
  return s;
}

// the query tile of this block and the number of key tiles it visits first
__device__ __forceinline__ void block_extent(const Params& p, int* qt,
                                             int* visit) {
  const int n_tiles = (p.T + kTile - 1) / kTile;
  *qt = p.causal ? n_tiles - 1 - (int)blockIdx.y : (int)blockIdx.y;
  *visit = p.causal ? *qt + 1 : n_tiles;
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core (mma.sync) path
// ---------------------------------------------------------------------------

// D: the head dim; DP: D rounded up to the mma depth of 16
template <int D, int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_bf16_kernel(const Params p) {
  static_assert(DP % 16 == 0 && DP >= D, "DP pads D to a multiple of 16");
  constexpr int kRow = DP + 8;      // q/k tile row stride: conflict-free reads
  constexpr int kVRow = kTile + 8;  // transposed v tile row stride
  constexpr int kVec = (D / 2) % 8 == 0 ? 8 : 4;  // bf16 per staging copy
  constexpr int kChunks = DP / kVec;              // staging copies per row
  using Vec = typename BfVec<kVec>::type;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [64][kRow]
  __nv_bfloat16* ks = qs + kTile * kRow;                         // [64][kRow]
  __nv_bfloat16* vt = ks + kTile * kRow;                         // [DP][kVRow]
  __shared__ float kb[kTile];

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // mma group: rows g and g + 8 of the warp's 16
  const int t4 = lane & 3;  // mma thread in group: columns 2*t4, 2*t4 + 1
  int qt, visit;
  block_extent(p, &qt, &visit);
  const int q0 = qt * kTile;
  const int n_tiles = (p.T + kTile - 1) / kTile;

  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.sk[0] + h * p.sk[1];
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.sv[0] + h * p.sv[1];

  for (int e = tid; e < kTile * kChunks; e += kMmaThreads) {
    const int r = e / kChunks;
    const int c = (e - r * kChunks) * kVec;
    const int qi = q0 + r;
    float x[kVec] = {};
    if (c < D && qi < p.T) {
      load_bf16<kVec>(qg + qi * p.sq[2] + c, x);
      if (p.sm_scale != 1.0f) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) x[i] = round_bf16(x[i] * p.sm_scale);
      }
    }
    store_bf16<kVec>(qs + r * kRow + c, x);
  }
  int qrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) qrow[r] = q0 + warp * 16 + g + 8 * r;
  __syncthreads();

  uint32_t qa[DP / 16][4];  // the warp's 16 q rows as mma A fragments
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const __nv_bfloat16* base = qs + (warp * 16 + g) * kRow + kk * 16 + 2 * t4;
    qa[kk][0] = ld_u32(base);
    qa[kk][1] = ld_u32(base + 8 * kRow);
    qa[kk][2] = ld_u32(base + 8);
    qa[kk][3] = ld_u32(base + 8 * kRow + 8);
  }

  float o[DP / 8][4];  // output accumulator, C fragments over DP/8 n-tiles
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8
  float l[2] = {0.0f, 0.0f};            // this thread's share of the sums

  int kt_end = visit;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile is fully consumed
    for (int e = tid; e < kTile * kChunks; e += kMmaThreads) {
      const int j = e / kChunks;
      const int c = (e - j * kChunks) * kVec;
      const int kj = k0 + j;
      Vec kr = {}, vr = {};
      if (c < D && kj < p.T) {
        kr = *reinterpret_cast<const Vec*>(kg + kj * p.sk[2] + c);
        vr = *reinterpret_cast<const Vec*>(vg + kj * p.sv[2] + c);
      }
      *reinterpret_cast<Vec*>(ks + j * kRow + c) = kr;
      const __nv_bfloat16* vh = reinterpret_cast<const __nv_bfloat16*>(&vr);
#pragma unroll
      for (int i = 0; i < kVec; ++i) vt[(c + i) * kVRow + j] = vh[i];
    }
    load_key_bias(p, b, h, k0, tid, kb);
    __syncthreads();

    // s = q . k^T for the warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const __nv_bfloat16* kb16 = ks + (j * 8 + g) * kRow + kk * 16 + 2 * t4;
        mma_16816(s[j], qa[kk], ld_u32(kb16), ld_u32(kb16 + 8));
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = j * 8 + 2 * t4 + (e & 1);
        s[j][e] = masked_score(p, s[j][e], kb[col], k0 + col, qrow[r]);
        mx[r] = fmaxf(mx[r], s[j][e]);
      }
    }
    float m_use[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the four threads of a group hold the same two rows
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // -inf only while every key seen lies beyond T; exp(-inf) = 0 below
      m_use[r] = m_new == -INFINITY ? 0.0f : m_new;
      alpha[r] = __expf(m[r] - m_use[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pj = __expf(s[j][e] - m_use[e >> 1]);
        l[e >> 1] += pj;
        s[j][e] = pj;
      }
    }

    // o += p . v: p's C fragments are the A fragments of 16-key steps
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const __nv_bfloat16* vb = vt + (n * 8 + g) * kVRow + kk * 16 + 2 * t4;
        mma_16816(o[n], pa, ld_u32(vb), ld_u32(vb + 8));
      }
    }

    if (kt == visit - 1 && visit < n_tiles) {
      // causal: a row with no live key so far takes the remaining tiles too
      const bool dead = (qrow[0] < p.T && m[0] == kNegInf) ||
                        (qrow[1] < p.T && m[1] == kNegInf);
      if (__syncthreads_or(dead)) kt_end = n_tiles;
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (qrow[r] >= p.T) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(p.o) + b * p.so[0] +
                          h * p.so[1] + qrow[r] * p.so[2];
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = n * 8 + 2 * t4;  // D is even: the pair is in or out
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: scalar path, one thread per query row
// ---------------------------------------------------------------------------

constexpr int kStep = 16;  // keys per online-softmax update

template <int D>
__global__ void __launch_bounds__(kTile)
flash_attention_f32_kernel(const Params p) {
  static_assert(D % 4 == 0, "float4 shared-memory reads");
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kTile][D]
  float* vs = ks + kTile * D;                   // [kTile][D]
  __shared__ float kb[kTile];

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int tid = threadIdx.x;
  int qt, visit;
  block_extent(p, &qt, &visit);
  const int qi = qt * kTile + tid;
  const bool q_live = qi < p.T;
  const int n_tiles = (p.T + kTile - 1) / kTile;

  const float* qg = static_cast<const float*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const float* kg = static_cast<const float*>(p.k) + b * p.sk[0] + h * p.sk[1];
  const float* vg = static_cast<const float*>(p.v) + b * p.sv[0] + h * p.sv[1];

  float q[D];
#pragma unroll
  for (int d = 0; d < D; ++d) q[d] = q_live ? qg[qi * p.sq[2] + d] * p.sm_scale : 0.0f;

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.0f;
  float m = -INFINITY;  // running max (-inf until a key is seen)
  float l = 0.0f;       // running denominator

  int kt_end = visit;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile is fully consumed
    for (int e = tid; e < kTile * D; e += kTile) {
      const int j = e / D;
      const int d = e - j * D;
      const int kj = k0 + j;
      ks[e] = kj < p.T ? kg[kj * p.sk[2] + d] : 0.0f;
      vs[e] = kj < p.T ? vg[kj * p.sv[2] + d] : 0.0f;
    }
    load_key_bias(p, b, h, k0, tid, kb);
    __syncthreads();

    for (int c = 0; c < kTile; c += kStep) {
      float s[kStep];
      float step_max = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kStep; ++jj) {
        const float4* kr = reinterpret_cast<const float4*>(ks + (c + jj) * D);
        float dot = 0.0f;
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 kk = kr[d4];
          dot = fmaf(q[4 * d4 + 0], kk.x, dot);
          dot = fmaf(q[4 * d4 + 1], kk.y, dot);
          dot = fmaf(q[4 * d4 + 2], kk.z, dot);
          dot = fmaf(q[4 * d4 + 3], kk.w, dot);
        }
        s[jj] = masked_score(p, dot, kb[c + jj], k0 + c + jj, qi);
        step_max = fmaxf(step_max, s[jj]);
      }
      const float m_new = fmaxf(m, step_max);
      if (m_new == -INFINITY) continue;  // only keys beyond T so far
      const float alpha = expf(m - m_new);  // 0 while m is -inf
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kStep; ++jj) {
        const float pj = expf(s[jj] - m_new);
        l += pj;
        const float4* vr = reinterpret_cast<const float4*>(vs + (c + jj) * D);
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4 + 0] = fmaf(pj, vv.x, acc[4 * d4 + 0]);
          acc[4 * d4 + 1] = fmaf(pj, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(pj, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(pj, vv.w, acc[4 * d4 + 3]);
        }
      }
      m = m_new;
    }

    if (kt == visit - 1 && visit < n_tiles) {
      // causal: a row with no live key so far takes the remaining tiles too
      if (__syncthreads_or(q_live && m == kNegInf)) kt_end = n_tiles;
    }
  }

  if (q_live) {
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    float* orow = static_cast<float*>(p.o) + b * p.so[0] + h * p.so[1] + qi * p.so[2];
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = acc[d] * inv;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D, int DP>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  const size_t smem = (2 * kTile * (DP + 8) + DP * (kTile + 8)) * sizeof(__nv_bfloat16);
  return launch_tiles(flash_attention_bf16_kernel<D, DP>, p, kMmaThreads, smem, stream);
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  return launch_tiles(flash_attention_f32_kernel<D>, p, kTile,
                      2 * kTile * D * sizeof(float), stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: 12 int64 values, the (b, h, t)
// strides of q, k, v and out in that order. kbias: float32 key-bias rows
// read at kbias[b * kb_b + h * kb_h + t], or null. Returns the launch's
// cudaGetLastError() (0 on success); the launch does not synchronise.
int pgym_flash_attention(const void* q, const void* k, const void* v,
                         void* out, const long long* strides, int B, int H,
                         int T, int D, int dtype, const float* kbias,
                         long long kb_b, long long kb_h, int causal,
                         float sm_scale, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[6 + i];
    p.so[i] = strides[9 + i];
  }
  p.kbias = kbias;
  p.kb_b = kb_b;
  p.kb_h = kb_h;
  p.sm_scale = sm_scale;
  p.B = B;
  p.H = H;
  p.T = T;
  p.causal = causal;
  if (B <= 0 || H <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (D) {
      case 16: return (int)launch_bf16<16, 16>(p, s);
      case 24: return (int)launch_bf16<24, 32>(p, s);
      case 32: return (int)launch_bf16<32, 32>(p, s);
      case 64: return (int)launch_bf16<64, 64>(p, s);
      case 128: return (int)launch_bf16<128, 128>(p, s);
    }
  } else if (dtype == 0) {
    switch (D) {
      case 16: return (int)launch_f32<16>(p, s);
      case 24: return (int)launch_f32<24>(p, s);
      case 32: return (int)launch_f32<32>(p, s);
      case 64: return (int)launch_f32<64>(p, s);
      case 128: return (int)launch_f32<128>(p, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

const char* pgym_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
