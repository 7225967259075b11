"""Multi-head attention: the hand-written Hopper kernels and their plain
versions (counterpart of proteingym_tpu/ops/flash_attention.py).

``grouped_mha`` wraps the CUDA kernel ``csrc/grouped_attention.cu``, the
port of the Pallas kernel ``_grouped_attention_kernel``. It takes the JAX
wrapper's argument contract: q/k/v (B, H, T, D), ``key_mask`` (B, T) bool
(True = attend), ``bias`` (H, T) additive per-head key bias, ``causal``,
``sm_scale``, ``rope_base`` (q/k arrive unrotated) and ``segment_ids``
(B, T) int, 0 = padding, for block-diagonal attention.

``grouped_mha_bthd`` is the port of the heads-mid Pallas kernel
``_bthd_attention_kernel``: the same math on (B, T, H, D) tensors without
a bias, launched through the (B, T, H, D) entry of the same CUDA source.

``flash_mha`` wraps ``csrc/flash_attention.cu``, the port of the Pallas
long-context kernel ``_attention_kernel``: the same contract without
``rope_base`` and ``segment_ids``; causal calls skip the key tiles above
the diagonal.

``seg_block_mha`` wraps ``csrc/seg_block_attention.cu``, the port of the
extent-sparse Pallas kernel ``_seg_block_kernel``: segmented attention
that visits only the key tiles sharing a segment with each query tile.

``mha`` and ``mha_natural`` dispatch as the JAX functions do on a TPU. On
a CPU tensor each wrapper runs its plain PyTorch version (``reference_mha``,
after in-graph RoPE where asked). On a CUDA tensor it launches its kernel
or raises for what the kernel does not take; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from proteingym_tpu_torch.ops.rotary import _cos_sin_cache, apply_rotary_bhtd

NEG_INF = -1e30
HEAD_DIMS = (16, 24, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# launches of each CUDA kernel entry in this process, counted by its wrapper
# where it launches the kernel and nowhere else
LAUNCHES = {"grouped_attention": 0, "grouped_attention_bthd": 0,
            "flash_attention": 0, "seg_block_attention": 0}

# Up to this context length ``mha`` takes the grouped kernel, beyond it the
# long-context kernel (the JAX dispatcher's threshold)
GROUPED_MAX_SEQ_LEN = 1024

# the JAX extent-sparse kernel's block edge; ``_seg_block_dispatch`` pads
# rows to a multiple of it, as the JAX dispatch does
SEG_BLOCK = 128
# the Hopper kernels' query and key tile edge (kTile in attention_common.cuh):
# the extent-sparse kernel's extents are counted in these tiles
KERNEL_TILE = 64


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def reference_mha(
    q, k, v, key_mask=None, bias=None, causal=False, sm_scale=None,
    segment_ids=None,
):
    """Plain attention: float32 scores and softmax, probabilities rounded to
    the input dtype for the value product, output in the input dtype."""
    b, h, t, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if bias is not None:
        scores = scores + bias.float()[None, :, None, :]
    if key_mask is not None:
        scores = scores.masked_fill(~key_mask.bool()[:, None, None, :], NEG_INF)
    if segment_ids is not None:
        same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        scores = scores.masked_fill(~same, NEG_INF)
    if causal:
        future = torch.ones(t, t, dtype=torch.bool, device=q.device).triu(1)
        scores = scores.masked_fill(future, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(q.dtype).float(), v.float()).to(q.dtype)


def plain_mha(q, k, v, key_mask=None, bias=None, causal=False, sm_scale=None,
              rope_base=None, segment_ids=None):
    """The kernel's plain version, with ``grouped_mha``'s contract: RoPE
    applied in-graph to unrotated q/k, then ``reference_mha``."""
    if rope_base is not None:
        q, k = apply_rotary_bhtd(q, k, rope_base)
    return reference_mha(q, k, v, key_mask=key_mask, bias=bias, causal=causal,
                         sm_scale=sm_scale, segment_ids=segment_ids)


def plain_mha_bthd(q, k, v, key_mask=None, causal=False, sm_scale=None,
                   rope_base=None, segment_ids=None):
    """``grouped_mha_bthd``'s plain version: ``plain_mha`` on (B, T, H, D)
    tensors, returning (B, T, H, D)."""
    tr = lambda x: x.transpose(1, 2)
    return tr(plain_mha(tr(q), tr(k), tr(v), key_mask=key_mask, causal=causal,
                        sm_scale=sm_scale, rope_base=rope_base,
                        segment_ids=segment_ids))


def plain_seg_block_mha(q, k, v, segment_ids, sm_scale=None, rope_base=None):
    """``seg_block_mha``'s plain version, in the JAX wrapper's order: RoPE
    in-graph, q scaled in float32 and rounded to the input dtype, then
    attention within segments (no key mask: callers fold it into the
    segment ids)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if rope_base is not None:
        q, k = apply_rotary_bhtd(q, k, rope_base)
    q = (q.float() * sm_scale).to(q.dtype)
    return reference_mha(q, k, v, sm_scale=1.0, segment_ids=segment_ids)


@functools.lru_cache(maxsize=1)
def _kernel_lib():
    from proteingym_tpu_torch.ops._build import load_library

    lib = load_library("grouped_attention")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pgym_grouped_attention.argtypes = [
        vp, vp, vp, vp, vp, i32, i32, i32, i32, i32,
        vp, vp, vp, i32, vp, vp, ctypes.c_float, vp,
    ]
    lib.pgym_grouped_attention.restype = i32
    lib.pgym_grouped_attention_bthd.argtypes = [
        vp, vp, vp, vp, vp, i32, i32, i32, i32, i32,
        vp, vp, i32, vp, vp, ctypes.c_float, vp,
    ]
    lib.pgym_grouped_attention_bthd.restype = i32
    lib.pgym_cuda_error_string.argtypes = [i32]
    lib.pgym_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=64)
def _rope_tables(t: int, d: int, base: float, device: torch.device):
    cos_np, sin_np = _cos_sin_cache(t, d, base)
    return (torch.from_numpy(cos_np).to(device),
            torch.from_numpy(sin_np).to(device))


def _aligned_rows(x: torch.Tensor) -> bool:
    """Every (b, h, t) row of a bf16 tensor starts on a 16-byte boundary."""
    return x.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in x.stride()[:3])


@functools.lru_cache(maxsize=1)
def _flash_lib():
    from proteingym_tpu_torch.ops._build import load_library

    lib = load_library("flash_attention")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pgym_flash_attention.argtypes = [
        vp, vp, vp, vp, vp, i32, i32, i32, i32, i32,
        vp, i64, i64, i32, ctypes.c_float, vp,
    ]
    lib.pgym_flash_attention.restype = i32
    lib.pgym_flash_error_string.argtypes = [i32]
    lib.pgym_flash_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=1)
def _seg_block_lib():
    from proteingym_tpu_torch.ops._build import load_library

    lib = load_library("seg_block_attention")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pgym_seg_block_attention.argtypes = [
        vp, vp, vp, vp, vp, i32, i32, i32, i32, i32,
        vp, vp, vp, i32, vp, vp, ctypes.c_float, vp,
    ]
    lib.pgym_seg_block_attention.restype = i32
    lib.pgym_seg_block_error_string.argtypes = [i32]
    lib.pgym_seg_block_error_string.restype = ctypes.c_char_p
    return lib


def _checked_qkv(q, k, v):
    """Raise for what the attention kernels do not take; return q/k/v with
    bf16 views that are not aligned for 16-byte loads copied."""
    b, h, t, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"the attention kernel takes float32 or bfloat16 q/k/v of one "
            f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the attention kernel "
                         f"(supported: {HEAD_DIMS})")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q/k/v must lie on one device")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the attention kernel needs a unit head-dim stride")
    if q.dtype == torch.bfloat16:
        # the bf16 kernel stages rows with 16-byte loads; a view that is not
        # aligned for them is copied to a fresh contiguous tensor first
        q, k, v = (x if _aligned_rows(x) else x.clone(memory_format=torch.contiguous_format)
                   for x in (q, k, v))
    return q, k, v


def _strides(q, k, v, out):
    """The first three strides of each tensor, 12 int64 values."""
    return (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )


def _checked_segments(segment_ids, b, t, dev):
    if segment_ids.shape != (b, t):
        raise ValueError(f"segment_ids must be (B, T)={b, t}, got {tuple(segment_ids.shape)}")
    return segment_ids.to(device=dev, dtype=torch.int32).contiguous()


def _ptr(x):
    return None if x is None else x.data_ptr()


def _launch_grouped_attention(q, k, v, key_mask, bias, causal, sm_scale,
                              rope_base, segment_ids, bthd=False):
    """Launch the grouped kernel on (B, H, T, D) views. With ``bthd`` the
    (B, T, H, D) entry is launched (no bias), given the strides of the
    (B, T, H, D) tensors behind the views."""
    q, k, v = _checked_qkv(q, k, v)
    b, h, t, d = q.shape
    dev = q.device
    # (B, T, H, D) memory seen as (B, H, T, D): the model's output projection
    # reads it back without a transpose
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=dev).permute(0, 2, 1, 3)
    if key_mask is not None:
        if key_mask.shape != (b, t):
            raise ValueError(f"key_mask must be (B, T)={b, t}, got {tuple(key_mask.shape)}")
        key_mask = key_mask.to(device=dev, dtype=torch.bool).contiguous()
    if bias is not None:
        if bias.shape != (h, t):
            raise ValueError(f"bias must be (H, T)={h, t}, got {tuple(bias.shape)}")
        bias = bias.to(device=dev, dtype=torch.float32).contiguous()
    if segment_ids is not None:
        segment_ids = _checked_segments(segment_ids, b, t, dev)
    cos = sin = None
    if rope_base is not None:
        cos, sin = _rope_tables(t, d, float(rope_base), dev)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)

    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if bthd:
            err = lib.pgym_grouped_attention_bthd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _strides(*(x.transpose(1, 2) for x in (q, k, v, out))),
                b, h, t, d, _DTYPE_CODES[q.dtype], _ptr(key_mask),
                _ptr(segment_ids), int(bool(causal)), _ptr(cos), _ptr(sin),
                float(sm_scale), stream,
            )
        else:
            err = lib.pgym_grouped_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _strides(q, k, v, out), b, h, t, d, _DTYPE_CODES[q.dtype],
                _ptr(key_mask), _ptr(bias), _ptr(segment_ids), int(bool(causal)),
                _ptr(cos), _ptr(sin), float(sm_scale), stream,
            )
    name = "grouped_attention_bthd" if bthd else "grouped_attention"
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.pgym_cuda_error_string(err).decode())
    LAUNCHES[name] += 1
    return out


def grouped_mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    rope_base: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused attention, (B, H, T, D) -> (B, H, T, D). CUDA tensors launch the
    Hopper kernel (any T, head dims in HEAD_DIMS, float32 or bfloat16); CPU
    tensors take the plain version. With ``rope_base`` q/k arrive unrotated.
    ``sm_scale`` None means 1/sqrt(D); 1.0 when the caller pre-scaled q."""
    if q.device.type == "cuda":
        return _launch_grouped_attention(q, k, v, key_mask, bias, causal,
                                         sm_scale, rope_base, segment_ids)
    if q.device.type == "cpu":
        return plain_mha(q, k, v, key_mask, bias, causal, sm_scale,
                         rope_base, segment_ids)
    raise ValueError(f"no attention path for device {q.device}")


def grouped_mha_bthd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    rope_base: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Heads-mid attention: q/k/v and the result are (B, T, H, D), the
    layout of the q/k/v projections, so nothing is transposed. No bias (as
    the TPU kernel takes none). CUDA tensors launch the grouped kernel's
    (B, T, H, D) entry (any T, head dims in HEAD_DIMS, float32 or
    bfloat16); CPU tensors take ``plain_mha_bthd``.

    ``key_mask`` and ``segment_ids`` are both honoured, as in ``grouped_mha``
    (the TPU kernel drops the key mask when segments are given, relying on
    padding being segment 0; callers that keep that contract see no
    difference)."""
    if q.device.type == "cuda":
        tr = lambda x: x.transpose(1, 2)
        return tr(_launch_grouped_attention(
            tr(q), tr(k), tr(v), key_mask, None, causal, sm_scale, rope_base,
            segment_ids, bthd=True))
    if q.device.type == "cpu":
        return plain_mha_bthd(q, k, v, key_mask=key_mask, causal=causal,
                              sm_scale=sm_scale, rope_base=rope_base,
                              segment_ids=segment_ids)
    raise ValueError(f"no attention path for device {q.device}")


def _key_bias(key_mask, bias, b, h, t, dev):
    """The long-context kernel's key-bias rows, as the JAX wrapper folds
    them: -1e30 at masked keys plus the (H, T) bias, float32. Returns
    (rows or None, batch stride, head stride); a row shared by all heads
    or all batch rows is stored once."""
    if key_mask is not None and key_mask.shape != (b, t):
        raise ValueError(f"key_mask must be (B, T)={b, t}, got {tuple(key_mask.shape)}")
    if bias is not None and bias.shape != (h, t):
        raise ValueError(f"bias must be (H, T)={h, t}, got {tuple(bias.shape)}")
    mask_row = None
    if key_mask is not None:
        key_mask = key_mask.to(device=dev, dtype=torch.bool)
        mask_row = torch.where(key_mask, 0.0, NEG_INF).to(torch.float32)
    if bias is not None:
        bias = bias.to(device=dev, dtype=torch.float32)
    if mask_row is None and bias is None:
        return None, 0, 0
    if bias is None:
        return mask_row.contiguous(), t, 0
    if mask_row is None:
        return bias.contiguous(), 0, t
    return (mask_row[:, None, :] + bias[None]).contiguous(), h * t, t


def _launch_flash_attention(q, k, v, key_mask, bias, causal, sm_scale):
    q, k, v = _checked_qkv(q, k, v)
    b, h, t, d = q.shape
    dev = q.device
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=dev).permute(0, 2, 1, 3)
    kbias, kb_b, kb_h = _key_bias(key_mask, bias, b, h, t, dev)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    lib = _flash_lib()
    with torch.cuda.device(dev):
        err = lib.pgym_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _strides(q, k, v, out), b, h, t, d, _DTYPE_CODES[q.dtype],
            _ptr(kbias), kb_b, kb_h, int(bool(causal)), float(sm_scale),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            "flash_attention launch failed: "
            + lib.pgym_flash_error_string(err).decode()
        )
    LAUNCHES["flash_attention"] += 1
    return out


def flash_mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Long-context fused attention, (B, H, T, D) -> (B, H, T, D), q/k
    already rotated. CUDA tensors launch the Hopper kernel (any T, head dims
    in HEAD_DIMS, float32 or bfloat16); CPU tensors take ``reference_mha``."""
    if q.device.type == "cuda":
        return _launch_flash_attention(q, k, v, key_mask, bias, causal, sm_scale)
    if q.device.type == "cpu":
        return reference_mha(q, k, v, key_mask=key_mask, bias=bias,
                             causal=causal, sm_scale=sm_scale)
    raise ValueError(f"no attention path for device {q.device}")


def _segment_block_extents(segment_ids: torch.Tensor, n_qb: int,
                           block: int = SEG_BLOCK):
    """(B, T) contiguous segment ids, T = n_qb * block -> per-query-block
    key-block extents [lo, hi) in ``block`` units, both (B, n_qb) int32, on
    the ids' device: the first block holding the start of any segment the
    query block touches, and one past the block holding the last end.
    ``block`` is SEG_BLOCK for the JAX kernel's extents and KERNEL_TILE for
    the Hopper kernel's."""
    b, t = segment_ids.shape
    if t != n_qb * block:
        raise ValueError(f"T={t} is not {n_qb} blocks of {block}")
    seg = segment_ids.long()
    idx = torch.arange(t, device=seg.device)[None].expand(b, t)
    change = seg[:, 1:] != seg[:, :-1]
    edge = torch.ones(b, 1, dtype=torch.bool, device=seg.device)
    is_start = torch.cat([edge, change], dim=1)
    start_tok = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
    is_end = torch.cat([change, edge], dim=1)
    end_rev = torch.cummax(torch.where(is_end, t - 1 - idx, 0).flip(1), dim=1).values
    end_tok = t - 1 - end_rev.flip(1)
    lo = start_tok.view(b, n_qb, block).amin(dim=-1) // block
    hi = end_tok.view(b, n_qb, block).amax(dim=-1) // block + 1
    return lo.int(), hi.int()


def _launch_seg_block_attention(q, k, v, segment_ids, sm_scale, rope_base):
    q, k, v = _checked_qkv(q, k, v)
    b, h, t, d = q.shape
    dev = q.device
    seg = _checked_segments(segment_ids, b, t, dev)
    n_qt = -(-t // KERNEL_TILE)
    # the extents of the last, ragged tile count its missing keys as padding
    seg_tiles = F.pad(seg, (0, n_qt * KERNEL_TILE - t))
    lo, hi = (x.contiguous() for x in _segment_block_extents(seg_tiles, n_qt, KERNEL_TILE))
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=dev).permute(0, 2, 1, 3)
    cos = sin = None
    if rope_base is not None:
        cos, sin = _rope_tables(t, d, float(rope_base), dev)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    lib = _seg_block_lib()
    with torch.cuda.device(dev):
        err = lib.pgym_seg_block_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _strides(q, k, v, out), b, h, t, d, _DTYPE_CODES[q.dtype],
            seg.data_ptr(), lo.data_ptr(), hi.data_ptr(), n_qt,
            _ptr(cos), _ptr(sin), float(sm_scale),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            "seg_block_attention launch failed: "
            + lib.pgym_seg_block_error_string(err).decode()
        )
    LAUNCHES["seg_block_attention"] += 1
    return out


def seg_block_mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: torch.Tensor,
    sm_scale: Optional[float] = None,
    rope_base: Optional[float] = None,
) -> torch.Tensor:
    """Extent-sparse block-diagonal attention for segment-packed rows,
    (B, H, T, D) -> (B, H, T, D). ``segment_ids`` (B, T) int, contiguous
    runs, 0 = padding; no key mask (fold it into the ids) and no bias or
    causal mask. Live queries get dense segmented attention; padding
    queries compute garbage that callers never consume. With ``rope_base``
    q/k arrive unrotated; ``sm_scale`` None means 1/sqrt(D).

    CUDA tensors launch the Hopper kernel, which visits only the key tiles
    that share a segment with each 64-query tile (any T, head dims in
    HEAD_DIMS, float32 or bfloat16); CPU tensors take
    ``plain_seg_block_mha``. The JAX kernel needs T to be a multiple of
    SEG_BLOCK; neither version here does."""
    if q.device.type == "cuda":
        return _launch_seg_block_attention(q, k, v, segment_ids, sm_scale, rope_base)
    if q.device.type == "cpu":
        return plain_seg_block_mha(q, k, v, segment_ids, sm_scale=sm_scale,
                                   rope_base=rope_base)
    raise ValueError(f"no attention path for device {q.device}")


def _seg_block_dispatch(q, k, v, segment_ids, sm_scale=None, rope_base=None):
    """Packed rows longer than GROUPED_MAX_SEQ_LEN: as the JAX dispatch
    does, pad T to a multiple of SEG_BLOCK (padding is segment 0, which
    live queries never attend), run ``seg_block_mha`` and slice the output
    back to T."""
    t = q.shape[2]
    t_pad = _round_up(t, SEG_BLOCK)
    if t_pad != t:
        q, k, v = (F.pad(x, (0, 0, 0, t_pad - t)) for x in (q, k, v))
        segment_ids = F.pad(segment_ids, (0, t_pad - t))
    return seg_block_mha(q, k, v, segment_ids, sm_scale=sm_scale,
                         rope_base=rope_base)[:, :, :t]


def mha(q, k, v, key_mask=None, bias=None, causal=False, sm_scale=None,
        rope_base=None, segment_ids=None):
    """Attention dispatch, as the JAX ``mha`` routes on a TPU:

    - T <= GROUPED_MAX_SEQ_LEN: ``grouped_mha`` (RoPE fused);
    - longer, without ``segment_ids``: RoPE in-graph when ``rope_base`` is
      set, then the long-context ``flash_mha``;
    - longer, with ``segment_ids``, no bias and not causal (ESM's packed
      rows): ``key_mask`` folded into the segment ids (masked keys join
      segment 0), then the extent-sparse ``seg_block_mha`` through
      ``_seg_block_dispatch``. The ids must run contiguously: a masked hole
      inside a segment would split its run;
    - longer, with ``segment_ids`` and causal or a bias (PoET's self tier):
      ``grouped_mha``, which has no context cap here. The JAX package takes
      its dense XLA path there, which computes the same function.

    Each wrapper runs its plain version on CPU tensors, so the routing is
    the same on both devices."""
    if q.shape[2] <= GROUPED_MAX_SEQ_LEN or (
            segment_ids is not None and (causal or bias is not None)):
        return grouped_mha(q, k, v, key_mask=key_mask, bias=bias, causal=causal,
                           sm_scale=sm_scale, rope_base=rope_base,
                           segment_ids=segment_ids)
    if segment_ids is None:
        if rope_base is not None:
            q, k = apply_rotary_bhtd(q, k, rope_base)
        return flash_mha(q, k, v, key_mask=key_mask, bias=bias, causal=causal,
                         sm_scale=sm_scale)
    if key_mask is not None:
        segment_ids = torch.where(key_mask.to(segment_ids.device, torch.bool),
                                  segment_ids, 0)
    return _seg_block_dispatch(q, k, v, segment_ids, sm_scale=sm_scale,
                               rope_base=rope_base)


def mha_natural(q, k, v, key_mask=None, bias=None, causal=False,
                sm_scale=None, rope_base=None, segment_ids=None):
    """Attention at the model's natural layout: q/k/v and the result are
    (B, T, H, D), the projection outputs seen per head.

    T <= GROUPED_MAX_SEQ_LEN without a bias goes to ``grouped_mha_bthd``;
    every other call goes to ``mha`` on transposed views. The JAX function
    takes the heads-mid kernel only behind an opt-in switch, and only where
    its model of the TPU's scoped VMEM says that all heads' (T, D) blocks
    fit (``BTHD_MAX_SEQ_LEN``, ``_bthd_block_q``); Hopper has no scoped
    VMEM and its kernel streams key tiles, so neither condition applies."""
    if q.shape[1] <= GROUPED_MAX_SEQ_LEN and bias is None:
        return grouped_mha_bthd(q, k, v, key_mask=key_mask, causal=causal,
                                sm_scale=sm_scale, rope_base=rope_base,
                                segment_ids=segment_ids)
    tr = lambda x: x.transpose(1, 2)
    return tr(mha(tr(q), tr(k), tr(v), key_mask=key_mask, bias=bias,
                  causal=causal, sm_scale=sm_scale, rope_base=rope_base,
                  segment_ids=segment_ids))
