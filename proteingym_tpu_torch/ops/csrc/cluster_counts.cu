// Sequence-weight neighbour counts of an alignment, hand-written for Hopper
// (sm_90a), with a plain C entry point loaded through ctypes.
//
// Replaces: the inner `kernel` of
// proteingym_tpu/msa/weights.py::num_cluster_members_pallas (the Pallas TPU
// kernel that computes EVE's sequence-weight denominators). For every
// sequence i of an (N, L) alignment it counts the sequences j (itself
// included) with
//     float(matches(i, j)) > thr[i],   thr[i] = float32(identity) * max(L_nongap(i), 1),
// where matches(i, j) is the number of columns at which i and j hold the
// same amino acid (codes 1..20; gaps, 0, and any other code never match).
// The comparison is the TPU kernel's: strict, in float32, against a
// threshold the wrapper computes in float32. The counts are exact integers;
// the N x N match matrix is never written.
//
// Design: the TPU kernel's Gram of the gap-free one-hot, on the int8 tensor
// cores. One foreign call runs two kernels:
//   1. one_hot_kernel expands the codes into an int8 one-hot (N, K_pad):
//      column c's 20 channels at bytes 20 c .. 20 c + 19 (as _one_hot_nogap
//      lays them out), K = 20 L zero-padded to a multiple of 128 bytes (one
//      128-byte swizzle row), codes outside 1..20 zero.
//   2. cluster_counts_kernel computes matches = onehot . onehot^T in tiles of
//      128 rows i x 256 columns j with wgmma m64n256k32 (s8 x s8 into s32:
//      exact for any L, no chunking of columns) and counts the hits of each
//      tile in its epilogue. One producer warp keeps a ring of kStages TMA
//      loads in flight (an A tile of 128 rows and a B tile of 256 rows, 128
//      bytes of K each, 128-byte swizzle; TMA zero-fills rows past N); two
//      consumer warpgroups each own 64 rows of the tile, with 128 s32
//      accumulators per thread. Both operands are K-major rows of the same
//      row-major one-hot, so nothing is transposed.
// matches is symmetric, so only tiles that hold a pair with i <= j run: the
// grid is persistent, block b takes the linear tile indices b, b +
// gridDim.x, ..., and tile_of maps an index onto the triangle. Within a tile the
// pair (i, j) counts once, whatever the tile's shape or place:
//     i < j:  a hit of row i against thr[i] and of row j against thr[j];
//     i == j: a hit of row i against thr[i];
//     i > j:  nothing (the tile holding (j, i) counted it).
// Row hits are summed over each quad with shuffles, column hits over the
// warp with shuffles (four 8-bit counters to a register) and over the
// warpgroups in shared memory; each row and column of a tile then adds to
// the (N,) int32 counts with one integer atomic, so the result does not
// depend on the order.
//
// What bounds it. At N = 16,384, L = 300 the upper-triangle Gram is
// N (N + 1) / 2 x 20 L x 2 = 1.61e12 operations: 0.814 ms at the H100's
// 1,979 int8 TOP/s. The one-hot (99 MB) does not fit the 50 MB L2 cache,
// and the 4,160 tiles would read 9.6 GB (2.9 ms at 3.35 TB/s) if nothing
// were reused, so the tile order decides which side bounds the kernel:
// tile_of numbers the tiles in bands of kGroup = 16 row tiles that walk the
// column tiles together, so the ~132 tiles in flight share ~16 A tiles and
// ~9 B tiles (~26 MB) and read each k-slice of them once from device memory.
// The persistent grid lets the producer load the next tile's first stages
// while the consumers count the last one's hits. Measured on the card
// (NVIDIA H100 80GB HBM3, 700 W), the Gram kernel takes ~1.03 ms at
// N = 16,384, L = 300 (~79% of the int8 peak) and the whole call ~1.18 ms
// (tools/torch_cluster_counts_profile.py). PERF.md keeps the numbers.

#include "hopper_common.cuh"

namespace {

constexpr int kNumAA = 20;
constexpr int kBM = 128;      // rows i per tile: two consumer warpgroups of 64
constexpr int kBN = 256;      // columns j per tile: wgmma's widest N
constexpr int kBK = 128;      // one-hot bytes per ring stage: one 128-byte swizzle row
constexpr int kBox = 128;     // rows per TMA box (B takes two)
constexpr int kStages = 4;    // ring depth
constexpr int kGroup = 16;    // row tiles per band of the tile order
constexpr int kRatio = kBN / kBM;  // row tiles per column tile
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kProducerWarp = kConsumers / 32;
constexpr int kABytes = kBM * kBK;
constexpr int kStageBytes = (kBM + kBN) * kBK;
constexpr int kBarOff = kStages * kStageBytes;
// the ring, its barriers, and slack to align the base to 1024 (the 128-byte
// swizzle's repeat)
constexpr int kSmem = kBarOff + 2 * kStages * 8 + 1024;
constexpr int kOneHotThreads = 256;
static_assert(kBN == kConsumers, "one consumer thread per tile column in the drain");
static_assert(kBN % kBM == 0 && kGroup % kRatio == 0, "bands start on a column tile");

// ---------------------------------------------------------------------------
// the one-hot pre-pass
// ---------------------------------------------------------------------------

// One thread writes 16 bytes of one row. Column c's hot byte sits at
// 20 c + code - 1, so the 16 bytes from k0 meet at most two columns:
// k0 / 20 and the next.
__global__ void __launch_bounds__(kOneHotThreads)
one_hot_kernel(const int* __restrict__ codes, int n, int length, int k_pad,
               uint4* __restrict__ out) {
  const int chunks = k_pad / 16;
  const long long idx = (long long)blockIdx.x * kOneHotThreads + threadIdx.x;
  if (idx >= (long long)n * chunks) return;
  const long long r = idx / chunks;
  const int k0 = (int)(idx - r * chunks) * 16;
  const int c0 = k0 / kNumAA;
  const int* row = codes + r * length;
  int hot[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int c = c0 + u;
    const int a = c < length ? row[c] : 0;
    // the hot byte's place in this thread's 16 bytes; -1 for no amino acid
    hot[u] = (a >= 1 && a <= kNumAA) ? kNumAA * c + a - 1 - k0 : -1;
  }
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    w[q] = 0u;
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (hot[u] >= 4 * q && hot[u] < 4 * q + 4) w[q] |= 1u << (8 * (hot[u] - 4 * q));
  }
  out[idx] = make_uint4(w[0], w[1], w[2], w[3]);
}

// ---------------------------------------------------------------------------
// the tile order: upper-triangle tiles in bands of kGroup row tiles
// ---------------------------------------------------------------------------

// Row tile ti holds rows kBM ti .. kBM ti + kBM - 1, column tile tj columns
// kBN tj .. kBN tj + kBN - 1; tile (ti, tj) holds a pair i <= j when
// ti < kRatio (tj + 1). Band b is row tiles kGroup b .. kGroup b + h - 1 (h
// = kGroup but for a ragged last band); it walks column tiles kGroup b /
// kRatio .. col_tiles - 1 left to right, each with its rows side by side, so
// its u-th column holds min(h, kRatio (u + 1)) row tiles.

// tiles in the first u columns of a band of h row tiles: the first p hold
// kRatio, 2 kRatio, ..., kRatio p rows (fewer than h), the others h
__host__ __device__ __forceinline__ int band_prefix(int u, int h) {
  const int p = u < (h - 1) / kRatio ? u : (h - 1) / kRatio;
  return kRatio * p * (p + 1) / 2 + (u - p) * h;
}

// row tiles of band b
__host__ __device__ __forceinline__ int band_rows(int b, int row_tiles) {
  return row_tiles - kGroup * b < kGroup ? row_tiles - kGroup * b : kGroup;
}

__host__ __device__ __forceinline__ int band_tiles(int b, int row_tiles, int col_tiles) {
  return band_prefix(col_tiles - kGroup / kRatio * b, band_rows(b, row_tiles));
}

// the upper-triangle tiles of all bands
__host__ __device__ __forceinline__ int count_tiles(int row_tiles, int col_tiles) {
  int total = 0;
  for (int b = 0; kGroup * b < row_tiles; ++b) total += band_tiles(b, row_tiles, col_tiles);
  return total;
}

// (row tile, column tile) of linear tile index t < count_tiles(...)
__device__ __forceinline__ int2 tile_of(int t, int row_tiles, int col_tiles) {
  int b = 0;
  for (int size; t >= (size = band_tiles(b, row_tiles, col_tiles)); ++b) t -= size;
  const int h = band_rows(b, row_tiles);
  const int p = (h - 1) / kRatio;  // columns near the diagonal, with fewer than h rows
  int u = 0;
  if (t >= band_prefix(p, h))
    u = p + (t - band_prefix(p, h)) / h;
  else
    while (band_prefix(u + 1, h) <= t) ++u;
  return make_int2(kGroup * b + t - band_prefix(u, h), kGroup / kRatio * b + u);
}

// ---------------------------------------------------------------------------
// wgmma: s8 operands, s32 accumulators
// ---------------------------------------------------------------------------

// wgmma descriptor of a K-major operand in 128-byte swizzle: rows 128 bytes
// apart, 8-row groups 1024 bytes apart (SBO), layout type 1
__device__ __forceinline__ uint64_t desc_k_major(const unsigned char* p) {
  return make_smem_desc(p, 16, 1024, 1);
}

// d (64 x 256, s32) = a (64 x 32, s8, smem K-major) . b (32 x 256, s8, smem
// K-major) [+ d when accumulate]
__device__ __forceinline__ void wgmma_s8_n256(uint32_t (&d)[128], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// the 256 consumer threads (named barrier 1; 0 is __syncthreads)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// ---------------------------------------------------------------------------
// the Gram and its count
// ---------------------------------------------------------------------------

// n_tiles = count_tiles(row_tiles, col_tiles); k_chunks: K_pad / kBK.
// kThreads threads, kSmem bytes of dynamic shared memory, a persistent grid.
__global__ void __launch_bounds__(kThreads, 1)
cluster_counts_kernel(const __grid_constant__ CUtensorMap tm, int n_tiles, int row_tiles,
                      int col_tiles, int n, int k_chunks, const float* __restrict__ thr,
                      int* __restrict__ counts) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* empty = full + kStages;
  __shared__ __align__(16) float col_thr[kBN];  // thr of the tile's columns
  __shared__ int col_hits[kBN];   // the tile's column hits, summed over its rows

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);  // the producer's expect_tx
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (threadIdx.x < kBN) col_hits[threadIdx.x] = 0;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp == kProducerWarp) {
    // ---- producer: the A and B k-slices of every tile, in order ---------
    if (lane == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int2 tile = tile_of(t, row_tiles, col_tiles);
        for (int kc = 0; kc < k_chunks; ++kc, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          unsigned char* st = smem + s * kStageBytes;
          mbar_arrive_expect_tx(&full[s], kStageBytes);
          tma_load(st, &tm, &full[s], kc * kBK, tile.x * kBM);
          tma_load(st + kABytes, &tm, &full[s], kc * kBK, tile.y * kBN);
          tma_load(st + kABytes + kBox * kBK, &tm, &full[s], kc * kBK, tile.y * kBN + kBox);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows i0 + 64 wg .. + 63 of a tile ----
  const int wg = warp >> 2;
  const int g = lane >> 2;  // rows g and g + 8 of the warp's 16
  const int t4 = lane & 3;  // columns 2 t4, 2 t4 + 1 of each 8-column block
  const int ctid = threadIdx.x;  // this thread's tile column in the drain
  uint32_t acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0u;

  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int2 tile = tile_of(t, row_tiles, col_tiles);
    const int i0 = tile.x * kBM;
    const int j0 = tile.y * kBN;
    int row[2];
    float row_thr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row[r] = i0 + 64 * wg + 16 * (warp & 3) + g + 8 * r;
      row_thr[r] = row[r] < n ? thr[row[r]] : 0.0f;
    }
    // read after the first consumer_sync below; the last tile's readers
    // passed its second one before this thread got here
    col_thr[ctid] = j0 + ctid < n ? thr[j0 + ctid] : 0.0f;

    // acc = the tile's matches: 4 wgmma of depth 32 per 128-byte stage; the
    // previous stage is released once its products have completed
    int prev = 0;
    for (int kc = 0; kc < k_chunks; ++kc, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const unsigned char* a = smem + s * kStageBytes + wg * 64 * kBK;
      const unsigned char* b = smem + s * kStageBytes + kABytes;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        wgmma_s8_n256(acc, desc_k_major(a + 32 * kk), desc_k_major(b + 32 * kk),
                      (kc | kk) != 0);
      wgmma_commit();
      if (kc > 0) {
        wgmma_wait<1>();
        mbar_arrive(&empty[prev]);
      }
      prev = s;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[prev]);

    // acc[4 q + e]: row row[e >> 1], column j0 + 8 q + 2 t4 + (e & 1).
    // Column hits: four 8-bit counters to a word, the counter of the
    // thread's local column 2 q + (e & 1) in byte (2 q + (e & 1)) & 3 of
    // word q >> 1; at most 2 per thread, 16 per warp.
    consumer_sync();
    int rh[2] = {0, 0};
    uint32_t ch[16];
#pragma unroll
    for (int w = 0; w < 16; ++w) ch[w] = 0u;
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const int c = 8 * q + 2 * t4;
      const float2 ct = *reinterpret_cast<const float2*>(&col_thr[c]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = j0 + c + (e & 1);
        const float m = (float)(int)acc[4 * q + e];
        if (col < n && row[r] <= col && m > row_thr[r]) ++rh[r];
        if (row[r] < col && row[r] < n && m > ((e & 1) ? ct.y : ct.x))
          ch[q >> 1] += 1u << (8 * (2 * (q & 1) + (e & 1)));
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the four threads of a quad hold the same rows
      rh[r] += __shfl_xor_sync(0xffffffffu, rh[r], 1);
      rh[r] += __shfl_xor_sync(0xffffffffu, rh[r], 2);
      if (t4 == 0 && row[r] < n && rh[r] != 0) atomicAdd(&counts[row[r]], rh[r]);
    }
#pragma unroll
    for (int w = 0; w < 16; ++w) {  // the eight threads with one t4 hold the same columns
      ch[w] += __shfl_xor_sync(0xffffffffu, ch[w], 4);
      ch[w] += __shfl_xor_sync(0xffffffffu, ch[w], 8);
      ch[w] += __shfl_xor_sync(0xffffffffu, ch[w], 16);
    }
    // each of the eight adds two of the sixteen words to the tile's columns
#pragma unroll
    for (int w = 0; w < 16; ++w) {
      if ((w & 7) != g) continue;
#pragma unroll
      for (int by = 0; by < 4; ++by) {
        const int v = (ch[w] >> (8 * by)) & 0xff;
        // byte by of word w: q = 2 w + (by >> 1), e & 1 = by & 1
        if (v != 0) atomicAdd(&col_hits[16 * w + 8 * (by >> 1) + 2 * t4 + (by & 1)], v);
      }
    }
    consumer_sync();
    const int v = col_hits[ctid];
    col_hits[ctid] = 0;
    if (v != 0 && j0 + ctid < n) atomicAdd(&counts[j0 + ctid], v);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// host side: the tensor map and the launches
// ---------------------------------------------------------------------------

extern "C" {

// codes: (n, length) int32; thr: (n,) float32 thresholds; counts: (n,)
// int32, zeroed by the caller; onehot: (n, k_pad) int8 scratch, k_pad a
// multiple of 128 and at least 20 length. Returns the launches'
// cudaGetLastError() (0 on success); nothing synchronises.
int pgym_cluster_counts(const int* codes, int n, int length, const float* thr, int* counts,
                        void* onehot, int k_pad, void* stream) {
  if (n <= 0 || length < 0 || k_pad <= 0 || k_pad % kBK != 0 ||
      (long long)k_pad < (long long)kNumAA * length)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long chunks = (long long)n * (k_pad / 16);
  one_hot_kernel<<<(unsigned)((chunks + kOneHotThreads - 1) / kOneHotThreads),
                   kOneHotThreads, 0, s>>>(codes, n, length, k_pad,
                                           static_cast<uint4*>(onehot));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tm;
  const cuuint64_t dims[2] = {(cuuint64_t)k_pad, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)k_pad};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)kBox};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&tm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, onehot, dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;

  static unsigned sized = 0;  // the devices (bits) whose smem limit is raised
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32 || !(sized & (1u << dev))) {
    err = cudaFuncSetAttribute(cluster_counts_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) sized |= 1u << dev;
  }
  const int row_tiles = (n + kBM - 1) / kBM, col_tiles = (n + kBN - 1) / kBN;
  const int n_tiles = count_tiles(row_tiles, col_tiles);
  const int grid = n_tiles < sms ? n_tiles : sms;
  cluster_counts_kernel<<<grid, kThreads, kSmem, s>>>(tm, n_tiles, row_tiles, col_tiles, n,
                                                      k_pad / kBK, thr, counts);
  return (int)cudaGetLastError();
}

const char* pgym_cluster_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
