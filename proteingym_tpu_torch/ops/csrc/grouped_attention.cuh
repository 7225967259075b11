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
// TPU kernel's two dot_generals run in float32. The AR zoo (ProGen2, RITA,
// ProtGPT2, ProGen3) reaches it at full width, causal, with head dims
// 64-256.
//
// Arithmetic: 3xTF32 on the tensor cores. Every float32 operand x of both
// products (q, k, v, and the float32 softmax weights p) is split into two
// TF32 values, hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and each
// product a.b is taken as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, the small
// terms first (CUTLASS's FastF32 order), accumulated in float32 by
// mma.sync.m16n8k8 (TF32 operands, float32 accumulators). The dropped
// a_lo.b_lo term and the rounding of lo put each product within ~2^-21 of
// its float32 value, where one TF32 pass is ~2^-11 off. The softmax is
// float32: running max, expf, a denominator floored at 1e-30, the
// normalisation deferred to the output.
//
// Bound: on the tensor cores, three TF32 passes per product, so
// 3 x 4 B H D T (T + 1) / 2 operations for a causal call at 495 TFLOP/s
// TF32, against q, k, v and out read or written once at 3.35 TB/s. At the
// zoo's 32 x 256 rows bytes bound every shape (0.050-0.160 ms) but
// RITA_xl's T=416 bucket (operations, 0.137 ms).
//
// Design. One block per (query tile, batch*head) of W warps, warp w owning
// query rows 16 w .. 16 w + 15 of the tile, the M of its mma.sync
// m16n8k8: W = 8 from D = 64 to 160 (so eight warps share each tile's
// split), 4 below and at D = 256, where q's planes leave room for no more.
// K/V tiles hold KT keys: 64 up to D = 64, 32 to D = 128, 16 above.
//   - q is loaded, scaled, rotated and split once per block by the thread
//     whose A fragments hold it (every load in flight before the first
//     use), into hi and lo planes in the A fragments' order: a warp reads
//     a k-step's fragments with two 16-byte loads a thread. Within each
//     8-column step, A column t4 is head-dim column 2 t4 and t4 + 4 is
//     2 t4 + 1, and K's B fragments take the same order, so each thread
//     reads column pairs (8-byte loads) and the dot products are unchanged.
//   - Each K/V tile arrives by cp.async (16-byte copies; rows at or beyond
//     T zero-filled) in a raw buffer whose row strides (8 mod 32 floats for
//     K, D + 4 for V) keep the split pass free of bank conflicts, and is
//     split once into hi/lo planes in the B fragments' order (one 16-byte
//     load gives a thread b0, b1 hi and lo). The next tile's copies run
//     under this tile's products; two __syncthreads a tile.
//   - Per tile and warp: S = Q.K^T (3 KT/8 D/8 mma), bias and masks (none
//     on a tile whose keys are all live for the warp's rows), the online
//     softmax on S's accumulators, then O += P.V (3 D/8 KT/8 mma). P goes
//     from S's accumulators to A fragments without a shuffle: within each
//     8-key step A column t4 is key 2 t4 and t4 + 4 is key 2 t4 + 1, the
//     order V's fragments were split in. O is rescaled only when a row's
//     max moved.
//   - The tensor cores truncate as they accumulate. The small terms
//     (lo.hi + hi.lo) keep sums of their own, joined to the big ones once,
//     and each tile's P.V starts from 0 and joins O rounded to nearest, so
//     truncating sums run over D/8 or KT/8 steps only: against float64 the
//     kernel's error is 1.0-1.6x the plain float32 version's (three passes
//     into one running sum: up to 11x).
//   - A warp skips a tile wholly in the future of its 16 rows unless one
//     of them has seen no live key. Causal calls stop at each query tile's
//     diagonal unless __syncthreads_or finds a row with no live key so far
//     (such a row averages v over all T keys), and the longest query tiles
//     start first.
// What holds it back (PERF.md): the kernel is latency-bound, not bound by
// the tensor pipe: dropping two of the three passes saves ~10%, the split
// pass costs ~20%, the softmax ~15%, and with 255 registers a thread (a
// few spills from D = 96 up) an SM runs 8 warps.
//
// Layout. q, k, v and out come with their batch, head and token strides (in
// elements, (b, h, t) order in Params); the head-dim stride must be 1 and
// rows 16-byte aligned (the wrapper copies other views). A (B, T, H, D)
// projection output is therefore read and written in place, with no
// transposes.

#pragma once

#include <math.h>

#include "attention_common.cuh"
#include "hopper_common.cuh"

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

// ---------------------------------------------------------------------------
// 3xTF32 pieces
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x ~ hi + lo, both TF32: hi = rna(x), lo = rna(x - hi) (x - hi is exact)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a . b: a 16 x 8 (row), b 8 x 8 (col), TF32 operands, float32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// b[n] = (b0 hi, b1 hi, b0 lo, b1 lo) for N independent accumulators:
// big[n] += a_hi.b_hi, small[n] += a_lo.b_hi + a_hi.b_lo (the small terms
// first). The tensor cores truncate as they accumulate, so the small terms
// keep a sum of their own, added to the big one once, rounded to nearest
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&big)[N][4], float (&small)[N][4],
                                           const uint32_t (&a_hi)[4], const uint32_t (&a_lo)[4],
                                           const uint4 (&b)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(small[n], a_lo, b[n].x, b[n].y);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(big[n], a_hi, b[n].x, b[n].y);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(small[n], a_hi, b[n].z, b[n].w);
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (src is
// then not read, but must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 mma.sync, a warp per 16 query rows
// ---------------------------------------------------------------------------

template <int D>
struct F32Shape {
  static_assert(D % 8 == 0 && D >= 16 && D <= 256, "head dim");
  // 8 warps sharing each tile's split from D = 64 to 160, where q's planes
  // for 128 rows still fit beside a tile (measured on an H100 at the AR
  // zoo's shapes); 4 at D = 256
  static constexpr int kWarps = D >= 64 && D <= 160 ? 8 : 4;  // of 16 query rows each
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;  // query rows per block
  static constexpr int kKeys = D <= 64 ? 64 : D <= 128 ? 32 : 16;  // keys per tile
  static constexpr int kSteps = D / 8;         // k-steps of q.k^T, n-tiles of p.v
  static constexpr int kKeySteps = kKeys / 8;  // n-tiles of q.k^T, k-steps of p.v
  // floats per staged row: K's rows are read two columns at a time, V's
  // one column of two keys at a time, each without bank conflicts
  static constexpr int kRawK = D + ((8 - D) % 32 + 32) % 32;  // == 8 (mod 32)
  static constexpr int kRawV = D + 4;                          // == 4 (mod 8)
  // d steps of p.v per pass over the key steps (its sums live in registers)
  static constexpr int kGroup = kSteps % 8 == 0 && kSteps <= 16 ? 8 : kSteps % 4 == 0 ? 4 : kSteps;
  static_assert(kSteps % kGroup == 0, "d groups");
  // bytes: q's hi and lo fragment planes, K's and V's fragments (hi and lo
  // of b0, b1 in one uint4), the raw K and V tiles
  static constexpr int kQPlane = kRows * D * 4;
  static constexpr int kFrag = kKeys * D * 8;
  static constexpr int kKOff = 2 * kQPlane;
  static constexpr int kVOff = kKOff + kFrag;
  static constexpr int kRawOff = kVOff + kFrag;
  static constexpr int kSmem = kRawOff + kKeys * (kRawK + kRawV) * 4;
  // two blocks an SM where their shared memory fits (4 warps up to D = 32)
  static constexpr int kBlocksPerSM = kSmem <= 110 * 1024 ? 2 : 1;
};

// One block of kThreads per (query tile of kRows rows, batch*head);
// see the top of the file. Fragment planes: q [warp][k-step][lane] (uint4
// a0..a3, hi and lo planes), K [key step][k-step][lane], V [key step][d
// step][lane] (uint4 b0 hi, b1 hi, b0 lo, b1 lo).
template <int D>
__global__ void __launch_bounds__(F32Shape<D>::kThreads, F32Shape<D>::kBlocksPerSM)
grouped_attention_f32_kernel(const Params p) {
  using S = F32Shape<D>;
  constexpr int KT = S::kKeys, NK = S::kSteps, NJ = S::kKeySteps;
  constexpr int RK = S::kRawK, RV = S::kRawV;
  constexpr int kGroup = S::kGroup, kThreads = S::kThreads, kRows = S::kRows;
  extern __shared__ __align__(16) unsigned char f32_smem[];
  uint4* q_hi = reinterpret_cast<uint4*>(f32_smem);
  uint4* q_lo = reinterpret_cast<uint4*>(f32_smem + S::kQPlane);
  uint4* k_frag = reinterpret_cast<uint4*>(f32_smem + S::kKOff);
  uint4* v_frag = reinterpret_cast<uint4*>(f32_smem + S::kVOff);
  float* k_raw = reinterpret_cast<float*>(f32_smem + S::kRawOff);  // [KT][RK]
  float* v_raw = k_raw + KT * RK;                                   // [KT][RV]
  __shared__ float kbias[KT];
  __shared__ int kseg[KT];
  __shared__ int kstate[KT];

  const int bh = blockIdx.z * gridDim.y + blockIdx.y;
  if (bh >= p.B * p.H) return;  // the last z slice's spare blocks
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  // causal: the query tiles with the most key tiles start first
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // rows g and g + 8 of the warp's 16
  const int t4 = lane & 3;  // columns 2 t4, 2 t4 + 1 of each 8-column block
  const int r0 = q0 + 16 * warp;
  const int row0 = r0 + g, row1 = r0 + g + 8;

  const float* qg = static_cast<const float*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const float* kg = static_cast<const float*>(p.k) + b * p.sk[0] + h * p.sk[1];
  const float* vg = static_cast<const float*>(p.v) + b * p.sv[0] + h * p.sv[1];

  // the raw K and V rows of key tile kt, by cp.async (16 bytes a copy)
  auto stage = [&](int kt) {
    const int k0 = kt * KT;
    constexpr int kChunks = KT * (D / 4);  // of each of K and V
    for (int e = tid; e < 2 * kChunks; e += kThreads) {
      const int is_v = e >= kChunks;
      const int r = e - is_v * kChunks;
      const int j = r / (D / 4);
      const int c = 4 * (r - j * (D / 4));
      const int kj = min(k0 + j, p.T - 1);  // rows at or beyond T: zeros
      const float* src = is_v ? vg + kj * p.sv[2] + c : kg + kj * p.sk[2] + c;
      cp_async16(is_v ? v_raw + j * RV + c : k_raw + j * RK + c, src, k0 + j < p.T);
    }
    cp_async_commit();
  };
  stage(0);

  // q: scaled, rotated and split by the thread whose A fragments hold it.
  // Within each 8-column step, A column t4 is head-dim column 2 t4 and
  // column t4 + 4 is 2 t4 + 1 (K's B fragments take the same order, so the
  // dot products are unchanged): each thread reads column pairs of rows g
  // and g + 8. Without RoPE every load is issued before the first use, so
  // the block waits for q once.
  auto store_q = [&](int kk, float2 x0, float2 x1) {  // rows g, g + 8
    uint4 hi, lo;
    split_tf32(x0.x, hi.x, lo.x);  // a0: row g, column 2 t4
    split_tf32(x1.x, hi.y, lo.y);  // a1: row g + 8, column 2 t4
    split_tf32(x0.y, hi.z, lo.z);  // a2: row g, column 2 t4 + 1
    split_tf32(x1.y, hi.w, lo.w);  // a3: row g + 8, column 2 t4 + 1
    q_hi[(warp * NK + kk) * 32 + lane] = hi;
    q_lo[(warp * NK + kk) * 32 + lane] = lo;
  };
  const float sc = p.sm_scale;
  const float* qrow0 = qg + min(row0, p.T - 1) * p.sq[2];
  const float* qrow1 = qg + min(row1, p.T - 1) * p.sq[2];
  if (p.cos_t == nullptr) {
    float2 x[NK][2];
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const int c = 8 * kk + 2 * t4;
      x[kk][0] = row0 < p.T ? *reinterpret_cast<const float2*>(qrow0 + c) : make_float2(0.f, 0.f);
      x[kk][1] = row1 < p.T ? *reinterpret_cast<const float2*>(qrow1 + c) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      store_q(kk, make_float2(x[kk][0].x * sc, x[kk][0].y * sc),
              make_float2(x[kk][1].x * sc, x[kk][1].y * sc));
  } else {
    // scaled, then rotate_half in float32: x cos - x[c + D/2] sin in the
    // first half, x cos + x[c - D/2] sin in the second
    auto rope = [&](const float* qrow, int qi, int c) {
      if (qi >= p.T) return make_float2(0.f, 0.f);
      const int pc = c < D / 2 ? c + D / 2 : c - D / 2;
      const float sign = c < D / 2 ? -1.0f : 1.0f;
      const float2 x = *reinterpret_cast<const float2*>(qrow + c);
      const float2 y = *reinterpret_cast<const float2*>(qrow + pc);
      const float2 cs = *reinterpret_cast<const float2*>(p.cos_t + (long long)qi * D + c);
      const float2 sn = *reinterpret_cast<const float2*>(p.sin_t + (long long)qi * D + c);
      return make_float2((x.x * sc) * cs.x + sign * (y.x * sc) * sn.x,
                         (x.y * sc) * cs.y + sign * (y.y * sc) * sn.y);
    };
#pragma unroll 4
    for (int kk = 0; kk < NK; ++kk) {
      const int c = 8 * kk + 2 * t4;
      store_q(kk, rope(qrow0, row0, c), rope(qrow1, row1, c));
    }
  }

  int qseg0 = 0, qseg1 = 0;
  if (p.seg != nullptr) {
    if (row0 < p.T) qseg0 = p.seg[(long long)b * p.T + row0];
    if (row1 < p.T) qseg1 = p.seg[(long long)b * p.T + row1];
  }
  float o[NK][4];  // rows g, g + 8 x columns 8 n + 2 t4, + 1
#pragma unroll
  for (int n = 0; n < NK; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};  // running max (-inf until a key is seen)
  float l[2] = {0.0f, 0.0f};            // this thread's share of the denominators

  const int n_kt = (p.T + KT - 1) / KT;
  const int n_diag = p.causal ? min(n_kt, (min(q0 + kRows, p.T) - 1) / KT + 1) : n_kt;
  for (int kt = 0; kt < n_kt; ++kt) {
    // a row that has seen no live key: every score so far is the fill
    const bool dead = (row0 < p.T && m[0] == kNegInf) || (row1 < p.T && m[1] == kNegInf);
    if (kt == n_diag) {
      // past the diagonal every key is masked for every row: only a row
      // with no live key at or before it needs the rest, to average v over
      // all T keys as the plain version does
      if (!__syncthreads_or(dead)) break;
      stage(kt);
    }
    const int k0 = kt * KT;
    cp_async_wait_all();
    __syncthreads();  // the raw tile is in; every warp is done with the last fragments

    // split K: fragment (key step nt, k-step kk, lane) holds key 8 nt + g,
    // columns 8 kk + 2 t4 and + 1 (q's order)
#pragma unroll 2
    for (int e = tid; e < NJ * NK * 32; e += kThreads) {
      const int f = e >> 5;  // e % 32 is this thread's lane
      const int j = 8 * (f / NK) + g;
      const int c = 8 * (f % NK) + 2 * t4;
      const float* kr = k_raw + j * RK;
      float2 x = *reinterpret_cast<const float2*>(kr + c);
      if (p.cos_t != nullptr && k0 + j < p.T) {
        const int pc = c < D / 2 ? c + D / 2 : c - D / 2;
        const float sign = c < D / 2 ? -1.0f : 1.0f;
        const float2 y = *reinterpret_cast<const float2*>(kr + pc);
        const float2 cs = *reinterpret_cast<const float2*>(p.cos_t + (long long)(k0 + j) * D + c);
        const float2 sn = *reinterpret_cast<const float2*>(p.sin_t + (long long)(k0 + j) * D + c);
        x = make_float2(x.x * cs.x + sign * y.x * sn.x, x.y * cs.y + sign * y.y * sn.y);
      }
      uint4 frag;
      split_tf32(x.x, frag.x, frag.z);
      split_tf32(x.y, frag.y, frag.w);
      k_frag[e] = frag;
    }
    // split V: fragment (key step jj, d step n, lane) holds column 8 n + g
    // of keys 8 jj + 2 t4 and + 1 (the A fragments' key order below)
#pragma unroll 2
    for (int e = tid; e < NJ * NK * 32; e += kThreads) {
      const int f = e >> 5;
      const int j = 8 * (f / NK) + 2 * t4;
      const int c = 8 * (f % NK) + g;
      uint4 frag;
      split_tf32(v_raw[j * RV + c], frag.x, frag.z);
      split_tf32(v_raw[(j + 1) * RV + c], frag.y, frag.w);
      v_frag[e] = frag;
    }
    load_key_info<KT>(p, b, h, k0, tid, kstate, kbias, kseg);
    __syncthreads();  // fragments and key state are in; the raw buffers are free
    if (kt + 1 < n_kt && kt + 1 != n_diag) stage(kt + 1);

    // a warp with no row below T, or on a tile wholly in its rows' future
    // while each of them has seen a live key, has nothing to add
    if (r0 >= p.T) continue;
    if (p.causal && k0 > r0 + 15 && !__any_sync(0xffffffffu, dead)) continue;

    // s = q . k^T: 16 rows x KT keys, the big and the small terms apart
    float s[NJ][4], s_lo[NJ][4];
#pragma unroll
    for (int n = 0; n < NJ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = s_lo[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const uint4 qa = q_hi[(warp * NK + kk) * 32 + lane];
      const uint4 qb = q_lo[(warp * NK + kk) * 32 + lane];
      const uint32_t a_hi[4] = {qa.x, qa.y, qa.z, qa.w};
      const uint32_t a_lo[4] = {qb.x, qb.y, qb.z, qb.w};
      uint4 kb[NJ];
#pragma unroll
      for (int n = 0; n < NJ; ++n) kb[n] = k_frag[(n * NK + kk) * 32 + lane];
      mma_3xtf32(s, s_lo, a_hi, a_lo, kb);
    }
#pragma unroll
    for (int n = 0; n < NJ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += s_lo[n][e];

    // s[n][e]: row g + 8 (e >> 1), key k0 + 8 n + 2 t4 + (e & 1); bias, then
    // masks, unless every key of the tile is live for every row of the warp
    const bool whole = p.key_mask == nullptr && p.seg == nullptr && k0 + KT <= p.T &&
                       (!p.causal || k0 + KT - 1 <= r0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NJ; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 8 * n + 2 * t4 + (e & 1);
        float x = s[n][e];
        if (p.bias != nullptr) x += kbias[j];
        if (!whole) {
          const int state = kstate[j];
          if (state == kMasked || (p.seg != nullptr && kseg[j] != (e >> 1 ? qseg1 : qseg0)) ||
              (p.causal && k0 + j > (e >> 1 ? row1 : row0)))
            x = kNegInf;
          if (state == kBeyondT) x = -INFINITY;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float m_use[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the four threads of a quad hold the same two rows
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // -inf only while every key seen lies beyond T; expf(-inf) = 0 below
      m_use[r] = m_new == -INFINITY ? 0.0f : m_new;
      alpha[r] = expf(m[r] - m_use[r]);  // 0 while m is -inf
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    // o is rescaled only when a row's max moved (once it settles, never)
    if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
    }

    // p, and o += p . v kGroup d steps at a time: this tile's sums start at
    // 0 and join o rounded to nearest, so the truncating sums run over KT
    // keys only. As A fragments of an 8-key step, column t4 is key 2 t4 and
    // column t4 + 4 key 2 t4 + 1, the order V's fragments were split in
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[jj][e] = expf(s[jj][e] - m_use[e >> 1]);
        l[e >> 1] += s[jj][e];
      }
#pragma unroll
    for (int n0 = 0; n0 < NK; n0 += kGroup) {
      float big[kGroup][4], small[kGroup][4];
#pragma unroll
      for (int n = 0; n < kGroup; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) big[n][e] = small[n][e] = 0.0f;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        uint32_t a_hi[4], a_lo[4];
        split_tf32(s[jj][0], a_hi[0], a_lo[0]);  // row g, key 2 t4
        split_tf32(s[jj][2], a_hi[1], a_lo[1]);  // row g + 8, key 2 t4
        split_tf32(s[jj][1], a_hi[2], a_lo[2]);  // row g, key 2 t4 + 1
        split_tf32(s[jj][3], a_hi[3], a_lo[3]);  // row g + 8, key 2 t4 + 1
        uint4 vb[kGroup];
#pragma unroll
        for (int n = 0; n < kGroup; ++n) vb[n] = v_frag[(jj * NK + n0 + n) * 32 + lane];
        mma_3xtf32(big, small, a_hi, a_lo, vb);
      }
#pragma unroll
      for (int n = 0; n < kGroup; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n0 + n][e] += big[n][e] + small[n][e];
    }
  }
  cp_async_wait_all();  // no copy is in flight when the block ends

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r ? row1 : row0;
    if (qi >= p.T) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    float* orow = static_cast<float*>(p.o) + b * p.so[0] + h * p.so[1] + qi * p.so[2];
#pragma unroll
    for (int n = 0; n < NK; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * t4) =
          make_float2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// a (query tiles, B*H) grid, B*H spread over y and z beyond 65,535 pairs;
// the dynamic shared-memory limit raised first (once per device) when the
// block needs more than 48 KB
template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  using S = F32Shape<D>;
  auto kernel = grouped_attention_f32_kernel<D>;
  if (S::kSmem > 48 * 1024) {
    static unsigned sized = 0;  // the devices (bits) whose limit is raised
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 32 || !(sized & (1u << dev))) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
      if (err != cudaSuccess) return err;
      if (dev < 32) sized |= 1u << dev;
    }
  }
  const long long bh = (long long)p.B * p.H;
  if (bh > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned gy = (unsigned)(bh < 65535 ? bh : 65535);
  const dim3 grid((p.T + S::kRows - 1) / S::kRows, gy, (unsigned)((bh + gy - 1) / gy));
  kernel<<<grid, S::kThreads, S::kSmem, stream>>>(p);
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
