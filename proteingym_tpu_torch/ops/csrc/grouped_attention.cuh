// The float32 device code of the attention entries in grouped_attention.cu:
// every wrapper (grouped_mha K1, flash_mha K2, seg_block_mha K3,
// grouped_mha_bthd K4) launches this float32 kernel for float32 q/k/v, and the
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
// It replaces ::_grouped_attention_kernel
// (proteingym_tpu/ops/flash_attention.py:181) on float32 operands, where the
// TPU kernel's two dot_generals run in float32: float32 products and float32
// accumulation, no TF32 and no bf16 tensor-core product (both round the
// operands). The AR zoo (ProGen2, RITA, ProtGPT2, ProGen3) reaches it at
// full width, causal, with head dims 64-256.
//
// Design. One block of 256 threads per (query tile, batch*head). A group of
// G lanes shares a query row (G = 8 when D is a multiple of 32; 4 at D=16, 2
// at D=24): lane g holds the float4 chunks g, g + G, ... of q and of the
// accumulator, D/G floats of each (32 + 32 at D=256), so no row spills. A
// score is the group's partial dots summed by __shfl_xor_sync. K/V tiles of
// 64 keys (32 at D >= 160, 64 KB at D=256, so two blocks share an SM) are
// staged in shared memory; the G lanes of a row read G neighbouring chunks
// of a key row, which the warp's other rows share as a broadcast. An online
// softmax (FlashAttention-2's scheme) keeps float32 running max, denominator
// and accumulator; the output is acc / max(denom, 1e-30). Causal calls stop
// at each query tile's diagonal key tile, and the longest tiles start first;
// a block holding a row that has seen no live key by its diagonal visits
// every tile, so that row averages v over all T keys as the plain version
// does. There is no cap on T.
//
// Bound: the float32 FMA rate outside the tensor cores (67 TFLOP/s on an
// H100 SXM), ~2 B H T^2 D operations for a causal call, against q, k, v and
// out read or written once. Each key costs a lane D/G FMAs for the score,
// log2(G) shuffles and D/G FMAs for the value, with shared-memory reads of
// the same count as FMA instructions: a 3xTF32 tensor-core split is the next
// step (ROADMAP queue 2). ptxas (-Xptxas -v, sm_90a, nvcc 12.9), registers
// a thread and no spills at every D: 80 (D=16), 103 (24), 78 (32), 92
// (64), 117 (96), 116 (128), 121 (160), 151 (256, one block an SM; under
// two blocks' cap of 128 it spilled 44 bytes). Neither 4 or 16 keys an
// update, nor 128-thread blocks, nor three blocks an SM moved the zoo's
// shapes by more than 20% on an H100 (PERF.md).
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

// per-key state of the KT-key tile starting at k0, one key per thread tid < KT
template <int KT>
__device__ __forceinline__ void load_key_info(const Params& p, int b, int h,
                                              int k0, int tid, int* kstate,
                                              float* kbias, int* kseg) {
  if (tid >= KT) return;
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
// float32: a group of lanes per query row
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;  // threads per block
constexpr int kF32Step = 8;       // keys per online-softmax update

// lanes per query row: the largest power of two up to 8 that divides the
// row's D/4 float4 chunks (8 for every D that is a multiple of 32, 4 at
// D=16, 2 at D=24)
template <int D>
__host__ __device__ constexpr int f32_lanes() {
  return (D / 4) % 8 == 0 ? 8 : (D / 4) % 4 == 0 ? 4 : 2;
}

// keys per shared-memory tile: 64, or 32 at D >= 160, so that the K and V
// tiles of two blocks or more fit on an SM (64 KB a block at D=256)
template <int D>
__host__ __device__ constexpr int f32_key_tile() {
  return D >= 160 ? 32 : 64;
}

__device__ __forceinline__ float4 f4_scale(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

// x * cos + sign * partner * sin, elementwise (rotate_half: the partner of
// a first-half chunk enters negated)
__device__ __forceinline__ float4 f4_rope(float4 x, float4 partner, float4 c, float4 s,
                                          float sign) {
  return make_float4(x.x * c.x + sign * partner.x * s.x, x.y * c.y + sign * partner.y * s.y,
                     x.z * c.z + sign * partner.z * s.z, x.w * c.w + sign * partner.w * s.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

// One block per (query tile of QR rows, batch*head): G = f32_lanes<D>() lanes
// share a query row, lane g holding the float4 chunks g, g + G, g + 2G, ... of
// q and of the accumulator, so that the G lanes of a row read G neighbouring
// chunks of a staged key or value row (one 128-byte wavefront at G=8, which
// the four rows of the warp share as a broadcast). A score is the lanes'
// partial dots summed with __shfl_xor_sync; every lane of the row then holds
// the same score, running max and denominator. Causal calls stop at the
// diagonal key tile unless a row of the block has seen no live key by then.
// Two blocks an SM cap a thread at 128 registers, which holds every D but
// 256: there the row's 64 floats of q and accumulator spill under the cap,
// so D=256 asks for one block an SM and gets the registers it needs.
template <int D>
__global__ void __launch_bounds__(kF32Threads, D >= 256 ? 1 : 2)
grouped_attention_f32_kernel(const Params p) {
  constexpr int G = f32_lanes<D>();
  constexpr int KT = f32_key_tile<D>();
  constexpr int NC = D / 4;            // float4 chunks of a row
  constexpr int CPL = NC / G;          // chunks of a lane
  constexpr int HALF = NC / 2;         // chunks of half a row (the rotation's partner)
  constexpr int QR = kF32Threads / G;  // query rows of a block
  static_assert(D % 8 == 0 && NC % G == 0 && KT % kF32Step == 0, "tile shapes");
  extern __shared__ float4 smem4[];
  float4* ks = smem4;            // [KT][NC]
  float4* vs = smem4 + KT * NC;  // [KT][NC]
  __shared__ float kbias[KT];
  __shared__ int kseg[KT];
  __shared__ int kstate[KT];

  const int bh = blockIdx.z * gridDim.y + blockIdx.y;
  if (bh >= p.B * p.H) return;  // the last z slice's spare blocks
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  // causal: the query tiles with the most key tiles start first
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * QR;
  const int tid = threadIdx.x;
  const int lane = tid % G;
  const int qi = q0 + tid / G;
  const bool q_live = qi < p.T;

  const float* kg = static_cast<const float*>(p.k) + b * p.sk[0] + h * p.sk[1];
  const float* vg = static_cast<const float*>(p.v) + b * p.sv[0] + h * p.sv[1];
  const float4* cos4 = reinterpret_cast<const float4*>(p.cos_t);
  const float4* sin4 = reinterpret_cast<const float4*>(p.sin_t);

  float4 q[CPL];
  int qseg = 0;
#pragma unroll
  for (int i = 0; i < CPL; ++i) q[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (q_live) {
    const float4* row = reinterpret_cast<const float4*>(
        static_cast<const float*>(p.q) + b * p.sq[0] + h * p.sq[1] + qi * p.sq[2]);
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + G * i;
      q[i] = f4_scale(row[c], p.sm_scale);
      if (p.cos_t != nullptr) {
        const int pc = c < HALF ? c + HALF : c - HALF;
        const long long t = (long long)qi * NC + c;
        q[i] = f4_rope(q[i], f4_scale(row[pc], p.sm_scale), cos4[t], sin4[t],
                       c < HALF ? -1.0f : 1.0f);
      }
    }
    if (p.seg != nullptr) qseg = p.seg[(long long)b * p.T + qi];
  }

  float4 acc[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float m = -INFINITY;  // running max (-inf until a key is seen)
  float l = 0.0f;       // running denominator

  const int n_kt = (p.T + KT - 1) / KT;
  const int n_diag = p.causal ? min(n_kt, (min(q0 + QR, p.T) - 1) / KT + 1) : n_kt;
  for (int kt = 0; kt < n_kt; ++kt) {
    // past the diagonal every key is masked for every row: only a row whose
    // scores so far are all the fill (no live key at or before it) needs the
    // rest, to average v over all T keys as the plain version does
    if (kt == n_diag && !__syncthreads_or(q_live && m == kNegInf)) break;
    const int k0 = kt * KT;
    __syncthreads();  // the previous tile is fully consumed
    for (int e = tid; e < KT * NC; e += kF32Threads) {
      const int j = e / NC;
      const int c = e - j * NC;
      const int kj = k0 + j;
      float4 kv = make_float4(0.0f, 0.0f, 0.0f, 0.0f), vv = kv;
      if (kj < p.T) {
        const float4* krow = reinterpret_cast<const float4*>(kg + kj * p.sk[2]);
        kv = krow[c];
        if (p.cos_t != nullptr) {
          const long long t = (long long)kj * NC + c;
          kv = f4_rope(kv, krow[c < HALF ? c + HALF : c - HALF], cos4[t], sin4[t],
                       c < HALF ? -1.0f : 1.0f);
        }
        vv = reinterpret_cast<const float4*>(vg + kj * p.sv[2])[c];
      }
      ks[e] = kv;
      vs[e] = vv;
    }
    load_key_info<KT>(p, b, h, k0, tid, kstate, kbias, kseg);
    __syncthreads();

#pragma unroll 1
    for (int c0 = 0; c0 < KT; c0 += kF32Step) {
      float s[kF32Step];
      float step_max = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kF32Step; ++jj) {
        const float4* kr = ks + (c0 + jj) * NC + lane;
        float dot = 0.0f;
#pragma unroll
        for (int i = 0; i < CPL; ++i) dot = dot4(q[i], kr[G * i], dot);
#pragma unroll
        for (int off = G / 2; off > 0; off /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[jj] = masked_score(p, dot, c0 + jj, k0, qi, qseg, kstate, kbias, kseg);
        step_max = fmaxf(step_max, s[jj]);
      }
      const float m_new = fmaxf(m, step_max);
      // with only keys beyond T so far (m_new = -inf) every weight is 0
      const float m_ref = m_new == -INFINITY ? 0.0f : m_new;
      const float alpha = expf(m - m_ref);  // 0 while m is -inf
      l *= alpha;
#pragma unroll
      for (int i = 0; i < CPL; ++i) acc[i] = f4_scale(acc[i], alpha);
#pragma unroll
      for (int jj = 0; jj < kF32Step; ++jj) {
        const float pj = expf(s[jj] - m_ref);
        l += pj;
        const float4* vr = vs + (c0 + jj) * NC + lane;
#pragma unroll
        for (int i = 0; i < CPL; ++i) axpy4(pj, vr[G * i], acc[i]);
      }
      m = m_new;
    }
  }

  if (q_live) {
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    float4* orow = reinterpret_cast<float4*>(static_cast<float*>(p.o) + b * p.so[0] +
                                             h * p.so[1] + qi * p.so[2]);
#pragma unroll
    for (int i = 0; i < CPL; ++i) orow[lane + G * i] = f4_scale(acc[i], inv);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// a (query tiles, B*H) grid, B*H spread over y and z beyond 65,535 pairs;
// the dynamic shared-memory limit raised first when the K/V tiles and the
// static per-key arrays together need more than 48 KB (D=96 and up)
template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  auto kernel = grouped_attention_f32_kernel<D>;
  constexpr int QR = kF32Threads / f32_lanes<D>();
  constexpr size_t kStatic = 3 * f32_key_tile<D>() * sizeof(int);  // kbias, kseg, kstate
  const size_t smem = 2 * f32_key_tile<D>() * D * sizeof(float);
  if (smem + kStatic > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long bh = (long long)p.B * p.H;
  if (bh > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned gy = (unsigned)(bh < 65535 ? bh : 65535);
  const dim3 grid((p.T + QR - 1) / QR, gy, (unsigned)((bh + gy - 1) / gy));
  kernel<<<grid, kF32Threads, smem, stream>>>(p);
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
  switch (D) {  // F32_HEAD_DIMS in flash_attention.py
    case 16: return launch_f32<16>(p, s);
    case 24: return launch_f32<24>(p, s);
    case 32: return launch_f32<32>(p, s);
    case 64: return launch_f32<64>(p, s);
    case 96: return launch_f32<96>(p, s);
    case 128: return launch_f32<128>(p, s);
    case 160: return launch_f32<160>(p, s);
    case 256: return launch_f32<256>(p, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
