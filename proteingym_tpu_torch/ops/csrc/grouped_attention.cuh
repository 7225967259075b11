// The float32 device code of the attention entries in grouped_attention.cu:
// every wrapper (grouped_mha K1, flash_mha K2, seg_block_mha K3,
// grouped_mha_bthd K4) launches this scalar kernel for float32 q/k/v, and the
// Hopper loop of hopper_attention.cuh for bfloat16. Params also carries the
// operands of the bf16 pre-pass (rope_qk_kernel in grouped_attention.cu).
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
//     cos/sin tables, rotated in float32,
//   - an optional softmax scale folded into q on load, before the rotation.
// A query row whose keys are all masked averages v uniformly over all T
// keys, as the plain version does; keys at or beyond T take no part.
//
// Design. One thread block per (batch*head, 64-query tile), one thread per
// query row with scalar float32 FMAs (the tensor cores would round the
// operands), a loop over every 64-key tile staged in shared memory, and an
// online softmax (FlashAttention-2's scheme) with float32 running max,
// denominator and accumulator. The output is acc / max(denom, 1e-30). There
// is no cap on T. It serves the small float32 presets and the tests; no card
// path runs it at a model's full width.
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
  float sm_scale;
  int B, H, T;
  int causal;
};

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

  const int n_tiles = (p.T + kTile - 1) / kTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
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

// a (B*H, ceil(T/kTile)) grid, the dynamic shared-memory limit raised first
// when the K/V tiles need more than 48 KB
template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  auto kernel = grouped_attention_f32_kernel<D>;
  const size_t smem = 2 * kTile * D * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(p.B * p.H, (p.T + kTile - 1) / kTile);
  kernel<<<grid, kTile, smem, stream>>>(p);
  return cudaGetLastError();
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

// The float32 kernel on float32 q/k/v. Returns the launch's
// cudaGetLastError() (cudaErrorInvalidValue for a shape the kernel does not
// take); the launch does not synchronise.
inline cudaError_t launch_grouped_f32(const Params& p, int D, cudaStream_t s) {
  if (p.B <= 0 || p.H <= 0 || p.T <= 0) return cudaErrorInvalidValue;
  switch (D) {
    case 16: return launch_f32<16>(p, s);
    case 24: return launch_f32<24>(p, s);
    case 32: return launch_f32<32>(p, s);
    case 64: return launch_f32<64>(p, s);
    case 128: return launch_f32<128>(p, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
