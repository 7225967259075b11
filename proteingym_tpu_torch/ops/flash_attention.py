"""Multi-head attention: the hand-written Hopper kernels and their plain
versions (counterpart of proteingym_tpu/ops/flash_attention.py).

``grouped_mha`` wraps the CUDA kernel ``csrc/grouped_attention.cu``, the
port of the Pallas kernel ``_grouped_attention_kernel``. It takes the JAX
wrapper's argument contract: q/k/v (B, H, T, D), ``key_mask`` (B, T) bool
(True = attend), ``bias`` (H, T) additive per-head key bias, ``causal``,
``sm_scale``, ``rope_base`` (q/k arrive unrotated) and ``segment_ids``
(B, T) int, 0 = padding, for block-diagonal attention.

``flash_mha`` wraps ``csrc/flash_attention.cu``, the port of the Pallas
long-context kernel ``_attention_kernel``: the same contract without
``rope_base`` and ``segment_ids``; causal calls skip the key tiles above
the diagonal.

``mha`` dispatches as the JAX ``mha`` does on a TPU. On a CPU tensor each
wrapper runs its plain PyTorch version (``reference_mha``, after in-graph
RoPE where asked). On a CUDA tensor it launches its kernel or raises for
what the kernel does not take; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from proteingym_tpu_torch.ops.rotary import _cos_sin_cache, apply_rotary_bhtd

NEG_INF = -1e30
HEAD_DIMS = (16, 24, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# launches of each CUDA kernel in this process, counted by its wrapper where
# it launches the kernel and nowhere else
LAUNCHES = {"grouped_attention": 0, "flash_attention": 0}

# Up to this context length ``mha`` takes the grouped kernel, beyond it the
# long-context kernel (the JAX dispatcher's threshold)
GROUPED_MAX_SEQ_LEN = 1024


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
    return (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )


def _launch_grouped_attention(q, k, v, key_mask, bias, causal, sm_scale,
                              rope_base, segment_ids):
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
        if segment_ids.shape != (b, t):
            raise ValueError(f"segment_ids must be (B, T)={b, t}, got {tuple(segment_ids.shape)}")
        segment_ids = segment_ids.to(device=dev, dtype=torch.int32).contiguous()
    cos = sin = None
    if rope_base is not None:
        cos, sin = _rope_tables(t, d, float(rope_base), dev)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    strides = _strides(q, k, v, out)

    def ptr(x):
        return None if x is None else x.data_ptr()

    lib = _kernel_lib()
    with torch.cuda.device(dev):
        err = lib.pgym_grouped_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            b, h, t, d, _DTYPE_CODES[q.dtype],
            ptr(key_mask), ptr(bias), ptr(segment_ids), int(bool(causal)),
            ptr(cos), ptr(sin), float(sm_scale),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            "grouped_attention launch failed: "
            + lib.pgym_cuda_error_string(err).decode()
        )
    LAUNCHES["grouped_attention"] += 1
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
            None if kbias is None else kbias.data_ptr(), kb_b, kb_h,
            int(bool(causal)), float(sm_scale),
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


def mha(q, k, v, key_mask=None, bias=None, causal=False, sm_scale=None,
        rope_base=None, segment_ids=None):
    """Attention dispatch, as the JAX ``mha`` routes on a TPU:

    - T <= GROUPED_MAX_SEQ_LEN: ``grouped_mha`` (RoPE fused);
    - longer, without ``segment_ids``: RoPE in-graph when ``rope_base`` is
      set, then the long-context ``flash_mha``;
    - longer, with ``segment_ids``: ``grouped_mha`` again, which has no
      context cap here. The JAX package sends these calls to XLA (causal)
      or to its block-sparse kernel K3 (not causal); the grouped kernel
      computes the same function, and K3 is not ported.

    Each wrapper runs its plain version on CPU tensors, so the routing is
    the same on both devices."""
    if q.shape[2] > GROUPED_MAX_SEQ_LEN and segment_ids is None:
        if rope_base is not None:
            q, k = apply_rotary_bhtd(q, k, rope_base)
        return flash_mha(q, k, v, key_mask=key_mask, bias=bias, causal=causal,
                         sm_scale=sm_scale)
    return grouped_mha(q, k, v, key_mask=key_mask, bias=bias, causal=causal,
                       sm_scale=sm_scale, rope_base=rope_base,
                       segment_ids=segment_ids)
