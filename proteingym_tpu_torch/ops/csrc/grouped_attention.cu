// Fused multi-head attention for short protein contexts and PoET's self
// tier, hand-written for Hopper (sm_90a), with plain C entry points loaded
// through ctypes. Three entries:
//
// pgym_grouped_attention (K1) replaces
// proteingym_tpu/ops/flash_attention.py::_grouped_attention_kernel (:181,
// the Pallas TPU kernel behind grouped_mha / mha for T <= 1024): q, k, v and
// out in (B, H, T, D) order of strides, with a key-padding mask, an (H, T)
// bias, segment ids, causal masking and RoPE.
//
// pgym_grouped_attention_bthd (K4) replaces ::_bthd_attention_kernel (:440,
// behind grouped_mha_bthd / mha_natural): the same math read and written in
// the model's (B, T, H, D) layout, with no bias operand, as the TPU kernel
// takes none. The TPU kernel holds every head of a (batch row, query block)
// in one program's VMEM to avoid four HBM transposes around the call; here
// the layout is only a matter of strides, so nothing is transposed.
//
// For bfloat16 both run, in one call, the pre-pass below (when the call asks
// for RoPE or a scale other than 1; its q' and k' go to a scratch buffer the
// caller passes) and then the Hopper loop of hopper_attention.cuh (TMA
// rings, wgmma, key-tile extents) on the rotated and scaled q and k. One
// entry for both keeps the host's work per call to one foreign call. For
// float32 both launch the scalar kernel of grouped_attention.cuh (the small
// float32 presets; tensor cores would round the operands), which rotates and
// scales on load.
//
// pgym_rope_qk launches the pre-pass alone: q' = rope(bf16(q * scale)) and
// k' = rope(k), written as (B, T, H, D) bf16. Its rounding steps are the
// plain version's (plain_rope_qk): q scaled in float32 and rounded to bf16;
// then x * cos and partner * sin each rounded to float32, their sum rounded
// to float32 (no fused multiply-add) and then to bf16, so that its output
// equals the plain version's bit for bit. It is bound by bytes (each q/k
// element read and written once, plus the (T, D) float32 tables): one
// thread per 16- or 8-byte chunk of a position, looping over the heads so
// that the tables are read once per position and not once per head.

#include "grouped_attention.cuh"
#include "hopper_attention.cuh"

namespace {

// One thread per chunk of kVec elements of a (b, t) position and group of
// kHeads heads (blockIdx.y): the chunk's cos/sin values are read once for
// the group's rows of q and of k, and the group's loads are in flight
// together. The rounding steps are the plain version's (see the top of the
// file): __fmul_rn / __fadd_rn keep the compiler from fusing the rotation's
// multiply-add. 32-bit indices: the launch refuses more than 2^31 chunks.
template <int D>
__global__ void __launch_bounds__(256) rope_qk_kernel(const Params p, __nv_bfloat16* q_out,
                                                      __nv_bfloat16* k_out) {
  constexpr int kVec = (D / 2) % 8 == 0 ? 8 : 4;  // a chunk never straddles the halves
  constexpr int kChunks = D / kVec;
  constexpr int kHalf = D / 2;
  constexpr int kHeads = 4;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int bt = e / kChunks;  // position in (b, t) order
  if (bt >= p.B * p.T) return;
  const int c = (e - bt * kChunks) * kVec;
  const int t = bt % p.T;
  const int b = bt / p.T;
  const int pc = c < kHalf ? c + kHalf : c - kHalf;  // the partner chunk
  const float sign = c < kHalf ? -1.0f : 1.0f;
  float cs[kVec], sn[kVec];
  const bool rope = p.cos_t != nullptr;
  if (rope) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      cs[i] = p.cos_t[(long long)t * D + c + i];
      sn[i] = sign * p.sin_t[(long long)t * D + c + i];
    }
  }
  for (int which = 0; which < (k_out != nullptr ? 2 : 1); ++which) {
    const long long* s = which ? p.sk : p.sq;
    const float scale = which ? 1.0f : p.sm_scale;
    const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(which ? p.k : p.q) +
                                b * s[0] + t * s[2];
    __nv_bfloat16* out = (which ? k_out : q_out) + (long long)bt * p.H * D + c;
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      const int h = blockIdx.y * kHeads + hh;
      if (h >= p.H) break;
      const __nv_bfloat16* row = base + h * s[1];
      float x[kVec], y[kVec] = {};
      load_bf16<kVec>(row + c, x);
      if (rope) load_bf16<kVec>(row + pc, y);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        if (scale != 1.0f) {
          x[i] = round_bf16(x[i] * scale);
          y[i] = round_bf16(y[i] * scale);
        }
        if (rope) x[i] = __fadd_rn(__fmul_rn(x[i], cs[i]), __fmul_rn(y[i], sn[i]));
      }
      store_bf16<kVec>(out + h * D, x);
    }
  }
}

template <int D>
cudaError_t launch_rope_qk(const Params& p, __nv_bfloat16* q_out, __nv_bfloat16* k_out,
                           cudaStream_t stream) {
  constexpr int kVec = (D / 2) % 8 == 0 ? 8 : 4;
  const long long n = (long long)p.B * p.T * (D / kVec);
  if (n + 255 > 0x7fffffffLL || (long long)p.B * p.T * p.H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + 255) / 256), (p.H + 3) / 4);  // kHeads heads per thread
  rope_qk_kernel<D><<<grid, 256, 0, stream>>>(p, q_out, k_out);
  return cudaGetLastError();
}

// the pre-pass on bf16 q, k with (b, h, t) strides sq, sk: q_out =
// rope(bf16(q * sm_scale)) and, when k_out is not null, k_out = rope(k),
// both (B, T, H, D) contiguous; cos_t/sin_t null means no rotation
cudaError_t rope_qk(const void* q, const void* k, const long long* sq, const long long* sk,
                    int B, int H, int T, int D, const float* cos_t, const float* sin_t,
                    float sm_scale, __nv_bfloat16* q_out, __nv_bfloat16* k_out,
                    cudaStream_t s) {
  if (B <= 0 || H <= 0 || T <= 0 || (cos_t == nullptr) != (sin_t == nullptr))
    return cudaErrorInvalidValue;
  Params p = make_params(q, k, nullptr, nullptr, B, H, T, nullptr, nullptr, 0, cos_t, sin_t,
                         sm_scale);
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = sq[i];
    p.sk[i] = sk[i];
  }
  switch (D) {
    case 16: return launch_rope_qk<16>(p, q_out, k_out, s);
    case 24: return launch_rope_qk<24>(p, q_out, k_out, s);
    case 32: return launch_rope_qk<32>(p, q_out, k_out, s);
    case 64: return launch_rope_qk<64>(p, q_out, k_out, s);
    case 128: return launch_rope_qk<128>(p, q_out, k_out, s);
  }
  return cudaErrorInvalidValue;
}

// bf16: the pre-pass (when there is RoPE or a scale other than 1, into
// `scratch`) and the Hopper loop; float32: the scalar kernel. strides: 12
// (b, h, t) values
cudaError_t launch_entry(const void* q, const void* k, const void* v, void* out,
                         const long long* strides, int B, int H, int T, int D, int dtype,
                         const unsigned char* key_mask, const float* bias, const int* seg,
                         int causal, const float* cos_t, const float* sin_t, float sm_scale,
                         const int* kt_lo, const int* kt_hi, int n_qt, void* scratch,
                         cudaStream_t stream) {
  if (dtype == 1) {
    if ((kt_lo == nullptr) != (kt_hi == nullptr) ||
        (kt_lo != nullptr && n_qt < (T + kQRows - 1) / kQRows))
      return cudaErrorInvalidValue;
    long long s[12];
    for (int i = 0; i < 12; ++i) s[i] = strides[i];
    if (cos_t != nullptr || sm_scale != 1.0f) {
      if (scratch == nullptr) return cudaErrorInvalidValue;
      auto q_r = static_cast<__nv_bfloat16*>(scratch);
      auto k_r = cos_t != nullptr ? q_r + (long long)B * T * H * D : nullptr;
      const cudaError_t err = rope_qk(q, k, strides, strides + 3, B, H, T, D, cos_t, sin_t,
                                      sm_scale, q_r, k_r, stream);
      if (err != cudaSuccess) return err;
      const long long bht[3] = {(long long)T * H * D, D, (long long)H * D};
      q = q_r;
      for (int i = 0; i < 3; ++i) s[i] = bht[i];
      if (k_r != nullptr) {
        k = k_r;
        for (int i = 0; i < 3; ++i) s[3 + i] = bht[i];
      }
    }
    HopperParams hp = {};
    hp.o = out;
    for (int i = 0; i < 3; ++i) hp.so[i] = s[9 + i];
    hp.key_mask = key_mask;
    hp.bias = bias;
    hp.seg = seg;
    hp.kt_lo = kt_lo;
    hp.kt_hi = kt_hi;
    hp.n_qt = n_qt;
    hp.B = B;
    hp.H = H;
    hp.T = T;
    hp.causal = causal;
    return launch_hopper_attention(q, k, v, s, hp, D, stream);
  }
  Params p = make_params(q, k, v, out, B, H, T, key_mask, seg, causal, cos_t, sin_t,
                         sm_scale);
  set_strides(p, strides);
  p.bias = bias;
  return launch_grouped(p, D, dtype, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: 12 int64 values, the (b, h, t)
// strides of q, k, v and out in that order. kt_lo, kt_hi: (B, n_qt) int32
// key-tile extents of each 128-query tile (bf16 only; null: every tile).
// scratch: for bf16 calls with RoPE or sm_scale != 1, room for q' (B*T*H*D
// bf16) and, with RoPE, k' after it; null otherwise. Returns the first
// launch error (0 on success); the launches do not synchronise.
int pgym_grouped_attention(const void* q, const void* k, const void* v, void* out,
                           const long long* strides, int B, int H, int T, int D, int dtype,
                           const unsigned char* key_mask, const float* bias, const int* seg,
                           int causal, const float* cos_t, const float* sin_t,
                           float sm_scale, const int* kt_lo, const int* kt_hi, int n_qt,
                           void* scratch, void* stream) {
  return (int)launch_entry(q, k, v, out, strides, B, H, T, D, dtype, key_mask, bias, seg,
                           causal, cos_t, sin_t, sm_scale, kt_lo, kt_hi, n_qt, scratch,
                           static_cast<cudaStream_t>(stream));
}

// The (B, T, H, D) entry: strides are 12 int64 values, the (b, t, h) strides
// of q, k, v and out in that order. No bias. Otherwise as above.
int pgym_grouped_attention_bthd(const void* q, const void* k, const void* v, void* out,
                                const long long* strides, int B, int H, int T, int D,
                                int dtype, const unsigned char* key_mask, const int* seg,
                                int causal, const float* cos_t, const float* sin_t,
                                float sm_scale, const int* kt_lo, const int* kt_hi, int n_qt,
                                void* scratch, void* stream) {
  long long bht[12];
  for (int x = 0; x < 4; ++x) {  // (b, t, h) -> (b, h, t)
    bht[3 * x] = strides[3 * x];
    bht[3 * x + 1] = strides[3 * x + 2];
    bht[3 * x + 2] = strides[3 * x + 1];
  }
  return (int)launch_entry(q, k, v, out, bht, B, H, T, D, dtype, key_mask, nullptr, seg,
                           causal, cos_t, sin_t, sm_scale, kt_lo, kt_hi, n_qt, scratch,
                           static_cast<cudaStream_t>(stream));
}

// The pre-pass alone: bf16 q, k with (b, h, t) strides (6 int64 values: q's,
// then k's) -> q_out = rope(bf16(q * sm_scale)) and, when k_out is not null,
// k_out = rope(k), both (B, T, H, D) contiguous bf16. cos_t/sin_t: (T, D)
// float32 tables, or null (no rotation: q_out = bf16(q * sm_scale)).
int pgym_rope_qk(const void* q, const void* k, void* q_out, void* k_out,
                 const long long* strides, int B, int H, int T, int D, const float* cos_t,
                 const float* sin_t, float sm_scale, void* stream) {
  return (int)rope_qk(q, k, strides, strides + 3, B, H, T, D, cos_t, sin_t, sm_scale,
                      static_cast<__nv_bfloat16*>(q_out), static_cast<__nv_bfloat16*>(k_out),
                      static_cast<cudaStream_t>(stream));
}

const char* pgym_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
