// The Hopper loop of the grouped attention kernels K1 and K4: bf16 q/k/v,
// TMA-fed shared-memory rings, wgmma tensor-core products and a float32
// online softmax in registers. grouped_attention.cu launches it from both
// of its entries (pgym_grouped_attention, the (B, H, T, D) entry, and
// pgym_grouped_attention_bthd, the (B, T, H, D) one); the extent-sparse
// kernel K3 stays on the mma.sync loop of grouped_attention.cuh.
//
// Replaces, for bfloat16 inputs: proteingym_tpu/ops/flash_attention.py::
// _grouped_attention_kernel (:181, behind grouped_mha) and
// ::_bthd_attention_kernel (:440, behind grouped_mha_bthd).
//
// What it computes: out = softmax(q.k^T [+ bias] [masked]) . v per (batch,
// head) on q and k that arrive ROTATED AND SCALED: the entries of
// grouped_attention.cu run their pre-pass (rope_qk_kernel) first when the
// call asks for RoPE or a scale other than 1. Masks, as in grouped_attention.cuh: a
// key-padding mask (masked keys take the finite fill -1e30, selected before
// the row max so they never anchor it), an additive (H, T) float32 key bias
// added before the max, (B, T) int32 segment ids (block-diagonal
// attention), causal masking; keys at or beyond T take no part (-inf).
// Probabilities are rounded to bf16 for p.v; the output is acc / max(l,
// 1e-30), rounded to bf16.
//
// Key-tile extents: with kt_lo/kt_hi (B, n_qt) the 128-query tile i of
// batch row b visits only the 64-key tiles [kt_lo, kt_hi). The wrapper
// fills them for segmented calls (from the runs of a row whose live ids
// rise run by run; every tile for any other row) and for causal ones (up
// to the diagonal tile, or every tile for a block holding a row that has
// no live key at or before it, so that such a row averages v over all T
// keys as the plain version does). With segments, rows of
// segment 0 (padding) see only the key tiles of their extent: their output
// is finite and differs from the plain version's, and callers never consume
// it. Live rows (segment > 0) get exact segmented attention.
//
// What bounds it. At ESM2-650M's window bucket (B=32, H=20, T=1024, D=64)
// a call needs 1.72e11 FLOP of products (174 us at 989 TFLOP/s) and moves
// 336 MB (100 us at 3.35 TB/s): the tensor cores bound it. At PoET's self
// tier the extents leave ~1.9e10 FLOP against 285 MB: bytes bound it. The
// mma.sync loop it replaces reached ~48 TFLOP/s: staging copies did not
// overlap the products, k was rotated again for every query tile, v was
// transposed through scalar stores and every score went through the mask
// select. Here:
//   - q and k are rotated and scaled once per call (the pre-pass);
//   - one producer warp keeps a ring of kStages K/V tiles in flight with
//     TMA (cp.async.bulk.tensor, mbarrier full/empty pairs), staging each
//     tile's per-key state (mask, segment, bias) beside it once, its loads
//     issued a tile ahead;
//   - two consumer warpgroups of 64 query rows each run S = Q.K^T as wgmma
//     with both operands in shared memory (K-major), the softmax in
//     registers, and O += P.V as wgmma with P from registers (bf16) and V
//     read from shared memory as an MN-major operand: nothing is transposed.
//     Each warpgroup runs its products and its softmax in turn; the other
//     warpgroup and the second block on the SM fill the gaps (making each
//     warpgroup alternate with the other at the tensor cores, or overlap
//     P.V of one tile with S of the next, measured no faster);
//   - a tile whose keys are all live, of one segment shared by the thread's
//     query rows, and wholly at or below the diagonal skips the per-element
//     select;
//   - query tiles of one (batch, head) are neighbours in the grid, so their
//     K/V tiles are read from HBM once and then from L2; up to D = 64 two
//     blocks share an SM, so one block's start (barriers, first loads)
//     overlaps the other's products.
// Measured on the card (NVIDIA H100 80GB HBM3, 700 W), the loop is not at
// either bound: ~0.6 ms at the window bucket (~275 TFLOP/s). By count the
// softmax's 6.7e8 exponentials there take the special-function units about
// as long as the products take the tensor cores. PERF.md keeps the numbers.
//
// Layout. q, k, v are read through 4-D TMA tensor maps (D, T, H, B) built
// on the host from the tensors' (b, h, t) strides (16-byte multiples, unit
// head-dim stride): a (B, T, H, D) projection output is read in place. The
// TMA box is DP wide, D rounded up to 16 (wgmma's depth): columns past D
// (D = 24) and rows past T are filled with zeros by the TMA unit. The
// shared-memory swizzle follows the box's row bytes (32, 64 or 128; D = 128
// takes two 64-column boxes) and the wgmma descriptors name the same mode.
// The output is written from registers with the (b, h, t) strides of out.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: nothing links libcuda)

#include "attention_common.cuh"

namespace {

constexpr int kQRows = 128;  // query rows per block: two consumer warpgroups
constexpr int kKeys = kTile;  // keys per ring stage
constexpr int kStages = 4;    // ring depth
constexpr int kConsumers = 256;  // two warpgroups
constexpr int kHopperThreads = kConsumers + 32;  // + one producer warp
constexpr int kProducerWarp = kConsumers / 32;

enum HopKeyState { kHopLive = 0, kHopMasked = 1, kHopBeyondT = 2 };

struct HopperParams {
  void* o;
  long long so[3];  // b, h, t strides of out, in elements
  const unsigned char* key_mask;  // (B, T), nonzero = attend; or null
  const float* bias;              // (H, T) or null
  const int* seg;                 // (B, T) or null
  const int* kt_lo;  // (B, n_qt) first key tile of each 128-query tile, or null
  const int* kt_hi;  // (B, n_qt) one past the last
  int n_qt;
  int B, H, T;
  int causal;
};

// the per-key state of one ring stage, written by the producer warp
struct KeyInfo {
  float bias[kKeys];
  int seg[kKeys];
  int state[kKeys];
  int all_live;  // every key of the tile is below T and not masked
  int seg_lo, seg_hi;
  int pad;  // keeps the size a multiple of 8: the arrays are read as int2/float2
};

// D rounded up to wgmma's depth of 16, the TMA box width and its swizzle
template <int DP>
struct HopperShape {
  static_assert(DP == 16 || DP == 32 || DP == 64 || DP == 128, "head dim");
  static constexpr int kBox = DP > 64 ? 64 : DP;  // columns per TMA box
  static constexpr int kBoxes = DP / kBox;        // boxes per 64-row tile
  static constexpr int kRowBytes = 2 * kBox;      // == the swizzle span
  static constexpr int kBoxBytes = kKeys * kRowBytes;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;  // 64 rows x DP
  // wgmma descriptor layout type: 1 = 128B, 2 = 64B, 3 = 32B swizzle
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  // bytes: Q (two warpgroups), K and V rings, key state, barriers, and
  // slack to align the base to 1024 (the 128B swizzle's repeat)
  static constexpr int kQOff = 0;
  static constexpr int kKOff = 2 * kTileBytes;
  static constexpr int kVOff = kKOff + kStages * kTileBytes;
  static constexpr int kInfoOff = kVOff + kStages * kTileBytes;
  static constexpr int kBarOff = kInfoOff + kStages * (int)sizeof(KeyInfo);
  static constexpr int kSmem = kBarOff + (1 + 2 * kStages) * 8 + 1024;
  // blocks resident per SM: two up to DP = 64, so that one block's start
  // (barriers, the Q and first K/V loads) overlaps the other's products;
  // DP = 128 needs the registers of one
  static constexpr int kBlocksPerSM = DP <= 64 ? 2 : 1;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one TMA box of a (D, T, H, B) tensor map into shared memory; completion
// is counted in bytes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int d0, int t0, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d0), "r"(t0), "r"(h),
      "r"(b)
      : "memory");
}

// a wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle layout type
template <int DP>
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (HopperShape<DP>::kLayout << 62);
}

// K-major operand (Q or K tile: 64 rows x DP, d contiguous), depth step kk
// of 16 columns: rows kRowBytes apart, 8-row groups 8 * kRowBytes apart
template <int DP>
__device__ __forceinline__ uint64_t desc_k_major(const unsigned char* tile, int kk) {
  using S = HopperShape<DP>;
  const int col = 16 * kk;
  return smem_desc<DP>(tile + (col / S::kBox) * S::kBoxBytes + (col % S::kBox) * 2, 16,
                       8 * S::kRowBytes);
}

// MN-major operand (V tile: 64 keys x DP, d contiguous, read as B of p.v
// with K = keys), key step kk of 16 rows: 8-key groups 8 * kRowBytes apart
// (SBO), the boxes of D = 128 kBoxBytes apart along d (LBO)
template <int DP>
__device__ __forceinline__ uint64_t desc_mn_major(const unsigned char* tile, int kk) {
  using S = HopperShape<DP>;
  return smem_desc<DP>(tile + 16 * kk * S::kRowBytes, S::kBoxBytes, 8 * S::kRowBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving register reads or writes of an
// accumulator across the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}


// ---------------------------------------------------------------------------
// wgmma: bf16 operands, float32 accumulators (64 rows per warpgroup)
// ---------------------------------------------------------------------------

// d (64 x 64, float32) = a (64 x 16, smem, K-major) . b (16 x 64, smem,
// K-major), accumulating into d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// o (64 x DP) += p (64 x 16 keys, bf16 A fragments) . v (16 keys x DP)
template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DP == 16) wgmma_rs_n16(o, a, db);
  else if constexpr (DP == 32) wgmma_rs_n32(o, a, db);
  else if constexpr (DP == 64) wgmma_rs_n64(o, a, db);
  else wgmma_rs_n128(o, a, db);
}

// D: the head dim; DP: D rounded up to 16. Grid (ceil(T / 128), B * H),
// kHopperThreads threads, HopperShape<DP>::kSmem bytes of dynamic shared
// memory.
template <int D, int DP>
__global__ void __launch_bounds__(kHopperThreads, HopperShape<DP>::kBlocksPerSM)
hopper_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const HopperParams p) {
  using S = HopperShape<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem + S::kQOff;  // [warpgroup][box][64 rows][kBox]
  unsigned char* ks = smem + S::kKOff;  // [stage][box][64 keys][kBox]
  unsigned char* vs = smem + S::kVOff;
  KeyInfo* kinfo = reinterpret_cast<KeyInfo*>(smem + S::kInfoOff);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::kBarOff);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = qt * kQRows;
  const int n_kt = (p.T + kKeys - 1) / kKeys;
  int kt_begin = 0, kt_end = n_kt;
  if (p.kt_lo != nullptr) {
    const long long e = (long long)b * p.n_qt + qt;
    kt_begin = max(p.kt_lo[e], 0);
    kt_end = min(p.kt_hi[e], n_kt);
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 33);  // the producer's expect_tx + its 32 lanes
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp == kProducerWarp) {
    // ---- producer: Q once, then K/V tiles and their key state ----------
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, 2 * S::kTileBytes);
      for (int wg = 0; wg < 2; ++wg)
        for (int c = 0; c < S::kBoxes; ++c)
          tma_load(qs + wg * S::kTileBytes + c * S::kBoxBytes, &tm_q, q_full, c * S::kBox,
                   q0 + 64 * wg, h, b);
    }
    // each lane's two keys of the next tile, loaded one tile ahead so that
    // their latency hides behind the wait for a free stage
    unsigned char nmask[2];
    float nbias[2];
    int nseg[2];
    auto fetch = [&](int kt) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kj = kt * kKeys + lane + 32 * u;
        const bool in = kj < p.T;
        nmask[u] = (in && p.key_mask != nullptr) ? p.key_mask[(long long)b * p.T + kj] : 1;
        nbias[u] = (in && p.bias != nullptr) ? p.bias[(long long)h * p.T + kj] : 0.0f;
        nseg[u] = (in && p.seg != nullptr) ? p.seg[(long long)b * p.T + kj] : 0;
      }
    };
    if (kt_begin < kt_end) fetch(kt_begin);
    for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      const int k0 = kt * kKeys;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * S::kTileBytes);
        for (int c = 0; c < S::kBoxes; ++c) {
          tma_load(ks + s * S::kTileBytes + c * S::kBoxBytes, &tm_k, &full[s], c * S::kBox,
                   k0, h, b);
          tma_load(vs + s * S::kTileBytes + c * S::kBoxBytes, &tm_v, &full[s], c * S::kBox,
                   k0, h, b);
        }
      }
      KeyInfo& ki = kinfo[s];
      bool live = true;
      int seg_lo = 0x7fffffff, seg_hi = -0x7fffffff;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = lane + 32 * u;
        const int state = k0 + j >= p.T ? kHopBeyondT : nmask[u] ? kHopLive : kHopMasked;
        ki.state[j] = state;
        ki.bias[j] = nbias[u];
        ki.seg[j] = nseg[u];
        live = live && state == kHopLive;
        seg_lo = min(seg_lo, nseg[u]);
        seg_hi = max(seg_hi, nseg[u]);
      }
      if (kt + 1 < kt_end) fetch(kt + 1);
      live = __all_sync(0xffffffffu, live);
      seg_lo = __reduce_min_sync(0xffffffffu, seg_lo);
      seg_hi = __reduce_max_sync(0xffffffffu, seg_hi);
      if (lane == 0) {
        ki.all_live = live;
        ki.seg_lo = seg_lo;
        ki.seg_hi = seg_hi;
      }
      mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 --------
  const int wg = warp >> 2;
  const int g = lane >> 2;  // rows g and g + 8 of the warp's 16
  const int t4 = lane & 3;  // columns 2 t4, 2 t4 + 1 of each 8-column block
  int row[2], qseg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = q0 + 64 * wg + 16 * (warp & 3) + g + 8 * r;
    qseg[r] = (p.seg != nullptr && row[r] < p.T) ? p.seg[(long long)b * p.T + row[r]] : 0;
  }
  const unsigned char* qtile = qs + wg * S::kTileBytes;

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the two rows
  float l[2] = {0.0f, 0.0f};            // this thread's share of the sums

  mbar_wait(q_full, 0);
  for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
    const int s = it % kStages;
    const int k0 = kt * kKeys;
    mbar_wait(&full[s], (it / kStages) & 1);
    const unsigned char* ktile = ks + s * S::kTileBytes;
    const unsigned char* vtile = vs + s * S::kTileBytes;

    // s = q . k^T: 64 rows x 64 keys per warpgroup, depth DP
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64(sc, desc_k_major<DP>(qtile, kk), desc_k_major<DP>(ktile, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // sc[4 j + e]: row row[e >> 1], key k0 + 8 j + 2 t4 + (e & 1)
    const KeyInfo& ki = kinfo[s];
    if (p.bias != nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 kb = *reinterpret_cast<const float2*>(&ki.bias[8 * j + 2 * t4]);
        sc[4 * j] += kb.x;
        sc[4 * j + 1] += kb.y;
        sc[4 * j + 2] += kb.x;
        sc[4 * j + 3] += kb.y;
      }
    }
    const bool whole = ki.all_live &&
                       (p.seg == nullptr || (ki.seg_lo == ki.seg_hi && ki.seg_lo == qseg[0] &&
                                             ki.seg_lo == qseg[1])) &&
                       (!p.causal || k0 + kKeys - 1 <= row[0]);
    if (!whole) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t4;
        const int2 st = *reinterpret_cast<const int2*>(&ki.state[c]);
        const int2 sg = *reinterpret_cast<const int2*>(&ki.seg[c]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int state = (e & 1) ? st.y : st.x;
          const int kseg = (e & 1) ? sg.y : sg.x;
          float x = sc[4 * j + e];
          if (state == kHopMasked || (p.seg != nullptr && kseg != qseg[r]) ||
              (p.causal && k0 + c + (e & 1) > row[r]))
            x = kNegInf;
          if (state == kHopBeyondT) x = -INFINITY;
          sc[4 * j + e] = x;
        }
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float m_use[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the four threads of a quad hold the same two rows
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
    for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    uint32_t pa[4][4];  // p as bf16 A fragments, one per 16-key step
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float pj = __expf(sc[i] - m_use[(i >> 1) & 1]);
      l[(i >> 1) & 1] += pj;
      sc[i] = pj;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16x2(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // o += p . v, v read MN-major (d contiguous) from the ring
    __syncwarp();
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_pv<DP>(o, pa[kk], desc_mn_major<DP>(vtile, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (row[r] >= p.T) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(p.o) + b * p.so[0] + h * p.so[1] +
                          row[r] * p.so[2];
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = 8 * n + 2 * t4;  // D is even: the pair is in or out
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and the launch
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda), looked up through the runtime's
// entry-point query so the library needs no -lcuda; null when missing
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// the (D, T, H, B) tensor map of a bf16 tensor with (b, h, t) strides s (in
// elements, unit head-dim stride), boxes of `box` columns x 64 rows
inline bool make_tensor_map(CUtensorMap* map, const void* base, int D, int T, int H, int B,
                            const long long* s, int box) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s[2] * 2, (cuuint64_t)s[1] * 2,
                                 (cuuint64_t)s[0] * 2};
  const cuuint32_t boxes[4] = {(cuuint32_t)box, (cuuint32_t)kKeys, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = box == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                strides, boxes, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// strides: 9 values, the (b, h, t) strides of q, k and v
template <int D, int DP>
cudaError_t launch_hopper(const void* q, const void* k, const void* v,
                          const long long* strides, const HopperParams& p,
                          cudaStream_t stream) {
  using S = HopperShape<DP>;
  CUtensorMap tq, tk, tv;
  if (!make_tensor_map(&tq, q, D, p.T, p.H, p.B, strides, S::kBox) ||
      !make_tensor_map(&tk, k, D, p.T, p.H, p.B, strides + 3, S::kBox) ||
      !make_tensor_map(&tv, v, D, p.T, p.H, p.B, strides + 6, S::kBox))
    return cudaErrorInvalidValue;
  auto kernel = hopper_attention_kernel<D, DP>;
  static unsigned sized = 0;  // the devices (bits) whose smem limit is raised
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || !(sized & (1u << dev))) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (err != cudaSuccess) return err;
    if (dev < 32) sized |= 1u << dev;
  }
  const dim3 grid((p.T + kQRows - 1) / kQRows, p.B * p.H);
  kernel<<<grid, kHopperThreads, S::kSmem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// bf16 q (rotated and scaled), k (rotated), v; head dims 16, 24, 32, 64, 128
inline cudaError_t launch_hopper_attention(const void* q, const void* k, const void* v,
                                           const long long* strides, const HopperParams& p,
                                           int D, cudaStream_t s) {
  if (p.B <= 0 || p.H <= 0 || p.T <= 0) return cudaErrorInvalidValue;
  switch (D) {
    case 16: return launch_hopper<16, 16>(q, k, v, strides, p, s);
    case 24: return launch_hopper<24, 32>(q, k, v, strides, p, s);
    case 32: return launch_hopper<32, 32>(q, k, v, strides, p, s);
    case 64: return launch_hopper<64, 64>(q, k, v, strides, p, s);
    case 128: return launch_hopper<128, 128>(q, k, v, strides, p, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
