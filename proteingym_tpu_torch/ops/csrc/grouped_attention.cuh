// The device code of the grouped attention kernel, shared by three entry
// points: the (B, H, T, D) and (B, T, H, D) entries in grouped_attention.cu
// and the extent-sparse segmented entry in seg_block_attention.cu. Each
// entry fills a Params and calls launch_grouped; none carries device code
// of its own.
//
// What it computes: out = softmax(q.k^T [+ bias] [masked]) . v per (batch,
// head), with
//   - an optional key-padding mask (masked keys take the finite fill -1e30,
//     selected so that they never anchor the row max),
//   - an optional additive (H, T) float32 key bias (ALiBi), added before the
//     max,
//   - optional (B, T) int32 segment ids: block-diagonal attention,
//   - causal masking,
//   - optional RoPE applied on load to unrotated q/k from (T, D) float32
//     cos/sin tables, rotated in float32 and rounded back to the input type
//     before the products,
//   - an optional softmax scale folded into q on load (rounded to the input
//     type, as the JAX wrapper folds it), before the rotation,
//   - optional key-tile extents: query tile i of batch row b visits only the
//     key tiles [kt_lo[b, i], kt_hi[b, i]) (all of them when null).
// A query row whose keys are all masked averages v uniformly over the keys
// of the tiles it visits (all T keys without extents), as the plain version
// does; keys at or beyond T take no part.
//
// Design. One thread block per (batch*head, 64-query tile), a loop over
// 64-key tiles staged in shared memory, and an online softmax
// (FlashAttention-2's scheme) with float32 running max, denominator and
// accumulator. The output is acc / max(denom, 1e-30), cast to the input
// type. There is no cap on T and no head grouping.
//
//   bfloat16: four warps, 16 query rows each. q.k^T and p.v run on the tensor
//     cores (mma.sync m16n8k16, bf16 operands, float32 accumulation); q stays
//     in registers as mma fragments, the score tile never leaves registers,
//     and p is rounded to bf16 for the p.v product, as the TPU kernels do.
//     Head dims that are not a multiple of 16 (24) are zero-padded to 32 in
//     shared memory.
//   float32: one thread per query row with scalar float32 FMAs (the tensor
//     cores would round the operands), for the small float32 presets.
//
// Layout. q, k, v and out come with their batch, head and token strides (in
// elements, (b, h, t) order in Params); the head-dim stride must be 1. A
// (B, T, H, D) projection output is therefore read and written in place,
// with no transposes.

#pragma once

#include <math.h>

#include "attention_common.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sq[3], sk[3], sv[3], so[3];  // b, h, t strides in elements
  const unsigned char* key_mask;         // (B, T), nonzero = attend; or null
  const float* bias;                     // (H, T) or null
  const int* seg;                        // (B, T) or null
  const float* cos_t;                    // (T, D) or null (no RoPE)
  const float* sin_t;
  const int* kt_lo;  // (B, n_qt) first key tile of each query tile, or null
  const int* kt_hi;  // (B, n_qt) one past the last key tile
  int n_qt;          // query tiles per batch row in kt_lo/kt_hi
  float sm_scale;
  int B, H, T;
  int causal;
};

// the key tiles [*begin, *end) that query tile qt of batch row b visits
__device__ __forceinline__ void key_tile_range(const Params& p, int b, int qt,
                                               int* begin, int* end) {
  const int n_tiles = (p.T + kTile - 1) / kTile;
  *begin = 0;
  *end = n_tiles;
  if (p.kt_lo != nullptr) {
    const long long e = (long long)b * p.n_qt + qt;
    *begin = max(p.kt_lo[e], 0);
    *end = min(p.kt_hi[e], n_tiles);
  }
}

enum KeyState { kLive = 0, kMasked = 1, kBeyondT = 2 };

// per-key state of the tile starting at k0, one key per thread tid < kTile
__device__ __forceinline__ void load_key_info(const Params& p, int b, int h,
                                              int k0, int tid, int* kstate,
                                              float* kbias, int* kseg) {
  if (tid >= kTile) return;
  const int kj = k0 + tid;
  int state = kBeyondT;
  float bias = 0.0f;
  int seg = 0;
  if (kj < p.T) {
    state = (p.key_mask != nullptr && !p.key_mask[(long long)b * p.T + kj])
                ? kMasked
                : kLive;
    if (p.bias != nullptr) bias = p.bias[(long long)h * p.T + kj];
    if (p.seg != nullptr) seg = p.seg[(long long)b * p.T + kj];
  }
  kstate[tid] = state;
  kbias[tid] = bias;
  kseg[tid] = seg;
}

// the score of (query qi in segment qseg, key k0 + j) after bias and masks:
// masked pairs take the finite fill, keys beyond T -inf (no part at all)
__device__ __forceinline__ float masked_score(const Params& p, float s, int j,
                                              int k0, int qi, int qseg,
                                              const int* kstate,
                                              const float* kbias,
                                              const int* kseg) {
  const int state = kstate[j];
  s += kbias[j];
  if (state == kMasked || (p.seg != nullptr && kseg[j] != qseg) ||
      (p.causal && k0 + j > qi))
    s = kNegInf;
  if (state == kBeyondT) s = -INFINITY;
  return s;
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core (mma.sync) path
// ---------------------------------------------------------------------------

// elements c..c+N-1 of row `row` (position t) of a q or k block, scaled (q
// only) and rotated in float32, each step rounded to bf16 as the TPU kernel
// rounds. N divides D/2, so a chunk never straddles the rotate-half seam.
template <int D, int N>
__device__ __forceinline__ void load_qk(const Params& p,
                                        const __nv_bfloat16* row, int t, int c,
                                        float scale, float* x) {
  constexpr int kHalf = D / 2;
  static_assert(kHalf % N == 0, "a chunk must not straddle the RoPE halves");
  load_bf16<N>(row + c, x);
  if (scale != 1.0f) {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = round_bf16(x[i] * scale);
  }
  if (p.cos_t == nullptr) return;
  float partner[N];
  load_bf16<N>(row + (c < kHalf ? c + kHalf : c - kHalf), partner);
  const float sign = c < kHalf ? -1.0f : 1.0f;
  const float4* cs = reinterpret_cast<const float4*>(p.cos_t + (long long)t * D + c);
  const float4* sn = reinterpret_cast<const float4*>(p.sin_t + (long long)t * D + c);
#pragma unroll
  for (int i4 = 0; i4 < N / 4; ++i4) {
    const float4 c4 = cs[i4];
    const float4 s4 = sn[i4];
    const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
    const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = 4 * i4 + u;
      float y = partner[i];
      if (scale != 1.0f) y = round_bf16(y * scale);
      x[i] = round_bf16(x[i] * cv[u] + sign * y * sv[u]);
    }
  }
}

// D: the head dim; DP: D rounded up to the mma depth of 16
template <int D, int DP>
__global__ void __launch_bounds__(kMmaThreads)
grouped_attention_bf16_kernel(const Params p) {
  static_assert(DP % 16 == 0 && DP >= D, "DP pads D to a multiple of 16");
  constexpr int kRow = DP + 8;      // q/k tile row stride: conflict-free reads
  constexpr int kVRow = kTile + 8;  // transposed v tile row stride
  constexpr int kVec = (D / 2) % 8 == 0 ? 8 : 4;  // bf16 per staging load
  constexpr int kChunks = DP / kVec;              // staging loads per row
  extern __shared__ float4 smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [64][kRow]
  __nv_bfloat16* ks = qs + kTile * kRow;                         // [64][kRow]
  __nv_bfloat16* vt = ks + kTile * kRow;                         // [DP][kVRow]
  __shared__ float kbias[kTile];
  __shared__ int kseg[kTile];
  __shared__ int kstate[kTile];

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // mma group: rows g and g + 8 of the warp's 16
  const int t4 = lane & 3;  // mma thread in group: columns 2*t4, 2*t4 + 1
  const int q0 = blockIdx.y * kTile;

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
    if (c < D && qi < p.T)
      load_qk<D, kVec>(p, qg + qi * p.sq[2], qi, c, p.sm_scale, x);
    store_bf16<kVec>(qs + r * kRow + c, x);
  }
  int qrow[2], qseg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qrow[r] = q0 + warp * 16 + g + 8 * r;
    qseg[r] = (p.seg != nullptr && qrow[r] < p.T)
                  ? p.seg[(long long)b * p.T + qrow[r]]
                  : 0;
  }
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

  int kt_begin, kt_end;
  key_tile_range(p, b, blockIdx.y, &kt_begin, &kt_end);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile is fully consumed
    for (int e = tid; e < kTile * kChunks; e += kMmaThreads) {
      const int j = e / kChunks;
      const int c = (e - j * kChunks) * kVec;
      const int kj = k0 + j;
      float kx[kVec] = {}, vx[kVec] = {};
      if (c < D && kj < p.T) {
        load_qk<D, kVec>(p, kg + kj * p.sk[2], kj, c, 1.0f, kx);
        load_bf16<kVec>(vg + kj * p.sv[2] + c, vx);
      }
      store_bf16<kVec>(ks + j * kRow + c, kx);
#pragma unroll
      for (int i = 0; i < kVec; ++i) vt[(c + i) * kVRow + j] = __float2bfloat16(vx[i]);
    }
    load_key_info(p, b, h, k0, tid, kstate, kbias, kseg);
    __syncthreads();

    // s = q . k^T for the warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const __nv_bfloat16* kb = ks + (j * 8 + g) * kRow + kk * 16 + 2 * t4;
        mma_16816(s[j], qa[kk], ld_u32(kb), ld_u32(kb + 8));
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        s[j][e] = masked_score(p, s[j][e], j * 8 + 2 * t4 + (e & 1), k0,
                               qrow[r], qseg[r], kstate, kbias, kseg);
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
grouped_attention_f32_kernel(const Params p) {
  static_assert(D % 4 == 0, "float4 shared-memory reads");
  constexpr int kHalf = D / 2;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kTile][D]
  float* vs = ks + kTile * D;                   // [kTile][D]
  __shared__ float kbias[kTile];
  __shared__ int kseg[kTile];
  __shared__ int kstate[kTile];

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int tid = threadIdx.x;
  const int qi = blockIdx.y * kTile + tid;
  const bool q_live = qi < p.T;

  const float* qg = static_cast<const float*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const float* kg = static_cast<const float*>(p.k) + b * p.sk[0] + h * p.sk[1];
  const float* vg = static_cast<const float*>(p.v) + b * p.sv[0] + h * p.sv[1];

  float q[D];
  int qseg = 0;
  if (q_live) {
    const float* row = qg + qi * p.sq[2];
#pragma unroll
    for (int d = 0; d < D; ++d) q[d] = row[d] * p.sm_scale;
    if (p.cos_t != nullptr) {
      const float* c = p.cos_t + (long long)qi * D;
      const float* s = p.sin_t + (long long)qi * D;
      float r[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float partner = d < kHalf ? -q[d + kHalf] : q[d - kHalf];
        r[d] = q[d] * c[d] + partner * s[d];
      }
#pragma unroll
      for (int d = 0; d < D; ++d) q[d] = r[d];
    }
    if (p.seg != nullptr) qseg = p.seg[(long long)b * p.T + qi];
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) q[d] = 0.0f;
  }

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.0f;
  float m = -INFINITY;  // running max (-inf until a key is seen)
  float l = 0.0f;       // running denominator

  int kt_begin, kt_end;
  key_tile_range(p, b, blockIdx.y, &kt_begin, &kt_end);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile is fully consumed
    for (int e = tid; e < kTile * D; e += kTile) {
      const int j = e / D;
      const int d = e - j * D;
      const int kj = k0 + j;
      float kv = 0.0f, vv = 0.0f;
      if (kj < p.T) {
        const float* krow = kg + kj * p.sk[2];
        kv = krow[d];
        if (p.cos_t != nullptr) {
          const float partner = d < kHalf ? -krow[d + kHalf] : krow[d - kHalf];
          const long long t = (long long)kj * D + d;
          kv = kv * p.cos_t[t] + partner * p.sin_t[t];
        }
        vv = vg[kj * p.sv[2] + d];
      }
      ks[e] = kv;
      vs[e] = vv;
    }
    load_key_info(p, b, h, k0, tid, kstate, kbias, kseg);
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
        s[jj] = masked_score(p, dot, c + jj, k0, qi, qseg, kstate, kbias, kseg);
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
  return launch_tiles(grouped_attention_bf16_kernel<D, DP>, p, kMmaThreads, smem, stream);
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  return launch_tiles(grouped_attention_f32_kernel<D>, p, kTile,
                      2 * kTile * D * sizeof(float), stream);
}

// The operands every entry passes; the optional ones may be null.
inline Params make_params(const void* q, const void* k, const void* v, void* out,
                          int B, int H, int T, const unsigned char* key_mask,
                          const int* seg, int causal, const float* cos_t,
                          const float* sin_t, float sm_scale) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.key_mask = key_mask;
  p.seg = seg;
  p.cos_t = cos_t;
  p.sin_t = sin_t;
  p.sm_scale = sm_scale;
  p.B = B;
  p.H = H;
  p.T = T;
  p.causal = causal;
  return p;
}

// The (b, h, t) strides of q, k, v and out, 12 values in that order, into p.
inline void set_strides(Params& p, const long long* strides) {
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[6 + i];
    p.so[i] = strides[9 + i];
  }
}

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaGetLastError()
// (cudaErrorInvalidValue for a shape or type the kernel does not take); the
// launch does not synchronise.
inline cudaError_t launch_grouped(const Params& p, int D, int dtype,
                                  cudaStream_t s) {
  if (p.B <= 0 || p.H <= 0 || p.T <= 0) return cudaErrorInvalidValue;
  if (dtype == 1) {
    switch (D) {
      case 16: return launch_bf16<16, 16>(p, s);
      case 24: return launch_bf16<24, 32>(p, s);
      case 32: return launch_bf16<32, 32>(p, s);
      case 64: return launch_bf16<64, 64>(p, s);
      case 128: return launch_bf16<128, 128>(p, s);
    }
  } else if (dtype == 0) {
    switch (D) {
      case 16: return launch_f32<16>(p, s);
      case 24: return launch_f32<24>(p, s);
      case 32: return launch_f32<32>(p, s);
      case 64: return launch_f32<64>(p, s);
      case 128: return launch_f32<128>(p, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace
