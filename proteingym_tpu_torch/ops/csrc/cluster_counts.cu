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
// same amino acid (gaps never match). The comparison is the TPU kernel's:
// strict, in float32, against a threshold the wrapper computes in float32.
// The counts are exact integers; the N x N match matrix is never written.
//
// Design. The TPU kernel computes matches as a bf16 Gram matrix of the
// gap-free one-hot (K = 20 L) on its matrix unit; the one-hot was a choice
// made for the MXU. Here the codes are compared directly: the wrapper packs
// each row's codes (0 = gap or no match, 1..20 = amino acid) four to a
// 32-bit word, and one word pair gives the matches of four columns with
// five integer instructions (SWAR):
//     x = a ^ b                       bytes of x are 0 where the codes agree
//     y = x + 0x7F7F7F7F              bit 7 of a byte: that byte of x is nonzero
//                                     (codes < 32, so no byte carries out)
//     acc += (~y >> 7) & nongap(a)    0x01 per agreeing non-gap byte
// That is 20x fewer operations than the one-hot Gram, on exact integers
// with no rounding question. Packed byte counters are folded into 32-bit
// counts every 32 words (bytes reach at most 32, their sum 128 < 256).
//
// One block of 256 threads takes a 64 x 64 tile of (i, j) pairs, each
// thread a 4 x 4 register tile; 32-word chunks of the 64 + 64 rows are
// staged in shared memory. matches is symmetric, so only tiles with
// tile_i <= tile_j run: an off-diagonal tile counts its hits for rows i
// against thr[i] and for rows j against thr[j]. Hits are summed per tile
// row in shared memory and added to the (N,) int32 counts with one atomic
// per row and tile: integer atomics, so the result does not depend on the
// order.
//
// What bounds it. At N = 16,384, L = 300 the half of the pair space is
// 1.34e8 pairs x 75 words x 5 instructions = 5.0e10 integer instructions:
// ~3.4 ms at the H100's 64 INT32 lanes per SM per clock (132 SMs,
// ~1.75 GHz). Bytes are no bound: the packed codes are 4.9 MB and stay in
// the L2 cache. A tensor-core Gram on int8 IMMA (2 N^2 20L = 3.2e12
// operations, ~1.6 ms at the int8 peak) is the faster design for a later
// PR; this one is the simple exact one.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlk = 64;      // rows of i (and of j) per block tile
constexpr int kWords = 32;    // packed words per shared-memory chunk
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 pairs each

__global__ void __launch_bounds__(kThreads)
cluster_counts_kernel(const uint32_t* __restrict__ codes, int n, int words,
                      const float* __restrict__ thr, int* __restrict__ counts) {
  const int ti = blockIdx.y;
  const int tj = blockIdx.x;
  if (ti > tj) return;  // matches is symmetric: the upper tiles cover all pairs
  __shared__ uint32_t as[kWords][kBlk + 1];  // +1: conflict-free staging
  __shared__ uint32_t bs[kWords][kBlk + 1];
  __shared__ int row_hits[kBlk];
  __shared__ int col_hits[kBlk];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // columns tx + 16 c
  const int ty = tid >> 4;  // rows ty + 16 r
  const int i0 = ti * kBlk;
  const int j0 = tj * kBlk;
  if (tid < kBlk) {
    row_hits[tid] = 0;
    col_hits[tid] = 0;
  }

  int total[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) total[r][c] = 0;

  for (int w0 = 0; w0 < words; w0 += kWords) {
    __syncthreads();  // the previous chunk is fully consumed
    for (int e = tid; e < kBlk * kWords; e += kThreads) {
      const int r = e / kWords;
      const int w = e - r * kWords;
      const int gw = w0 + w;
      as[w][r] = (i0 + r < n && gw < words) ? codes[(long long)(i0 + r) * words + gw] : 0u;
      bs[w][r] = (j0 + r < n && gw < words) ? codes[(long long)(j0 + r) * words + gw] : 0u;
    }
    __syncthreads();

    uint32_t acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0u;
#pragma unroll 4
    for (int w = 0; w < kWords; ++w) {
      uint32_t a[4], live[4], bw[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[r] = as[w][ty + 16 * r];
        // 0x01 in every byte of a that holds an amino acid (code != 0)
        live[r] = ((a[r] + 0x7F7F7F7Fu) >> 7) & 0x01010101u;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) bw[c] = bs[w][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t y = (a[r] ^ bw[c]) + 0x7F7F7F7Fu;
          acc[r][c] += (~y >> 7) & live[r];
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) total[r][c] += (int)((acc[r][c] * 0x01010101u) >> 24);
  }

  // hits of rows i against thr[i]; off the diagonal also of rows j
  const bool mirror = ti != tj;
  float ti_thr[4], tj_thr[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gi = i0 + ty + 16 * r;
    ti_thr[r] = gi < n ? thr[gi] : INFINITY;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int gj = j0 + tx + 16 * c;
    tj_thr[c] = gj < n ? thr[gj] : INFINITY;
  }
  int rh[4] = {0, 0, 0, 0}, ch[4] = {0, 0, 0, 0};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float m = (float)total[r][c];
      // a pair with j (or i) beyond n has thr INFINITY on that side and
      // zero matches on the other: it never counts
      if (j0 + tx + 16 * c < n && m > ti_thr[r]) ++rh[r];
      if (mirror && i0 + ty + 16 * r < n && m > tj_thr[c]) ++ch[c];
    }
  __syncthreads();  // row_hits/col_hits are zeroed
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (rh[r]) atomicAdd(&row_hits[ty + 16 * r], rh[r]);
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (ch[c]) atomicAdd(&col_hits[tx + 16 * c], ch[c]);
  __syncthreads();
  if (tid < kBlk) {
    if (i0 + tid < n && row_hits[tid]) atomicAdd(&counts[i0 + tid], row_hits[tid]);
    if (j0 + tid < n && col_hits[tid]) atomicAdd(&counts[j0 + tid], col_hits[tid]);
  }
}

}  // namespace

extern "C" {

// codes: (n, words) packed uint32 rows, four codes per word (0 = no match);
// thr: (n,) float32 thresholds; counts: (n,) int32, zeroed by the caller.
// Returns the launch's cudaGetLastError() (0 on success); the launch does
// not synchronise.
int pgym_cluster_counts(const void* codes, int n, int words, const float* thr,
                        int* counts, void* stream) {
  if (n <= 0 || words <= 0) return (int)cudaErrorInvalidValue;
  const int tiles = (n + kBlk - 1) / kBlk;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;  // grid.y limit
  const dim3 grid(tiles, tiles);
  cluster_counts_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(codes), n, words, thr, counts);
  return (int)cudaGetLastError();
}

const char* pgym_cluster_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
