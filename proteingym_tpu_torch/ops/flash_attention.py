"""Multi-head attention: the hand-written Hopper kernels and their plain
versions (counterpart of proteingym_tpu/ops/flash_attention.py).

Four wrappers, one per Pallas kernel, all launching the entries of the CUDA
source ``csrc/grouped_attention.cu``:

- ``grouped_mha``, the port of ``_grouped_attention_kernel``. It takes the
  JAX wrapper's argument contract: q/k/v (B, H, T, D), ``key_mask`` (B, T)
  bool (True = attend), ``bias`` (H, T) additive per-head key bias,
  ``causal``, ``sm_scale``, ``rope_base`` (q/k arrive unrotated) and
  ``segment_ids`` (B, T) int, 0 = padding, for block-diagonal attention;
- ``grouped_mha_bthd``, the port of the heads-mid ``_bthd_attention_kernel``:
  the same math on (B, T, H, D) tensors without a bias, through the
  (B, T, H, D) entry;
- ``flash_mha``, the port of the long-context ``_attention_kernel``: the
  contract without ``rope_base`` and ``segment_ids`` (PoET's multi tier);
- ``seg_block_mha``, the port of the extent-sparse ``_seg_block_kernel``:
  segmented attention with a key mask, no bias and no causal mask (ESM's
  segment-packed rows).

For bfloat16 each runs, in one foreign call, a pre-pass kernel that rotates
and scales q and k once (``rope_qk`` launches it alone) and the Hopper loop
(``csrc/hopper_attention.cuh``), which visits only the key tiles of
``_key_tile_extents`` for segmented and causal calls. A model computes
those once per forward through a ``KeyTiles`` it passes to every layer.
Padding rows (segment 0) of a segmented call are finite but are not the
plain version's; callers never consume them. For float32 each launches
the kernel of ``csrc/grouped_attention.cuh``: both products on the tensor
cores in 3xTF32 (every operand split into two TF32 halves, float32 sums,
so the result keeps float32's accuracy), head dims ``F32_HEAD_DIMS`` (the
AR zoo's 96, 160 and 256 among them), causal calls stopped at each query
tile's diagonal.

``mha`` and ``mha_natural`` dispatch as the JAX functions do on a TPU. On
a CPU tensor each wrapper runs its plain PyTorch version (``reference_mha``,
after in-graph RoPE where asked). On a CUDA tensor it launches its kernel
or raises for what the kernel does not take; there is no fallback.

The kernels have no backward: they write their results through raw
pointers, so under autograd their output would carry no gradient and the
projections before them would silently get none. With grad mode on, every
wrapper (and ``rope_qk``) therefore raises for a tensor that requires a
gradient, on either device, and names its plain version, which is
differentiable. The JAX package has no VJP for its Pallas kernels either:
its one training step traces the XLA attention.
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
HEAD_DIMS = (16, 24, 32, 64, 128)  # bfloat16: the Hopper loop
F32_HEAD_DIMS = (16, 24, 32, 64, 96, 128, 160, 256)  # float32: the 3xTF32 kernel
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# launches of each CUDA kernel entry in this process, counted by its wrapper
# where it launches the kernel and nowhere else
LAUNCHES = {"grouped_attention": 0, "grouped_attention_bthd": 0, "rope_qk": 0,
            "flash_attention": 0, "seg_block_attention": 0}

# Up to this context length ``mha`` takes the grouped kernel, beyond it the
# long-context kernel (the JAX dispatcher's threshold)
GROUPED_MAX_SEQ_LEN = 1024

# the Hopper loop's key tile edge (kTile in attention_common.cuh): extents
# are counted in key tiles
KERNEL_TILE = 64
# query rows per block of the Hopper loop (kQRows in hopper_attention.cuh)
Q_TILE = 128


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
              rope_base=None, segment_ids=None, key_tiles=None):
    """The kernel's plain version, with ``grouped_mha``'s contract: RoPE
    applied in-graph to unrotated q/k, then ``reference_mha``. Every key
    takes part, so ``key_tiles`` goes unused."""
    if rope_base is not None:
        q, k = apply_rotary_bhtd(q, k, rope_base)
    return reference_mha(q, k, v, key_mask=key_mask, bias=bias, causal=causal,
                         sm_scale=sm_scale, segment_ids=segment_ids)


def plain_mha_bthd(q, k, v, key_mask=None, causal=False, sm_scale=None,
                   rope_base=None, segment_ids=None, key_tiles=None):
    """``grouped_mha_bthd``'s plain version: ``plain_mha`` on (B, T, H, D)
    tensors, returning (B, T, H, D)."""
    tr = lambda x: x.transpose(1, 2)
    return tr(plain_mha(tr(q), tr(k), tr(v), key_mask=key_mask, causal=causal,
                        sm_scale=sm_scale, rope_base=rope_base,
                        segment_ids=segment_ids))


def plain_rope_qk(q, k, sm_scale=1.0, rope_base=None):
    """``rope_qk``'s plain version: q scaled in float32 and rounded to the
    input dtype, then q and k rotated in float32 and rounded again (the
    TPU kernels' order). Returns (B, H, T, D) q', k'."""
    if sm_scale != 1.0:
        q = (q.float() * sm_scale).to(q.dtype)
    if rope_base is not None:
        q, k = apply_rotary_bhtd(q, k, rope_base)
    return q, k


def plain_seg_block_mha(q, k, v, segment_ids, key_mask=None, sm_scale=None,
                        rope_base=None):
    """``seg_block_mha``'s plain version, in the JAX wrapper's order: RoPE
    in-graph, q scaled in float32 and rounded to the input dtype, then
    attention within segments to the keys ``key_mask`` keeps (the JAX
    dispatch folds the mask into the ids: masked keys join segment 0,
    which live rows never attend, so live rows see the same keys)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if rope_base is not None:
        q, k = apply_rotary_bhtd(q, k, rope_base)
    q = (q.float() * sm_scale).to(q.dtype)
    return reference_mha(q, k, v, key_mask=key_mask, sm_scale=1.0, segment_ids=segment_ids)


@functools.lru_cache(maxsize=1)
def _kernel_lib():
    from proteingym_tpu_torch.ops._build import load_library

    lib = load_library("grouped_attention")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pgym_grouped_attention.argtypes = [
        vp, vp, vp, vp, vp, i32, i32, i32, i32, i32,
        vp, vp, vp, i32, vp, vp, ctypes.c_float, vp, vp, i32, vp, vp,
    ]
    lib.pgym_grouped_attention.restype = i32
    lib.pgym_grouped_attention_bthd.argtypes = [
        vp, vp, vp, vp, vp, i32, i32, i32, i32, i32,
        vp, vp, i32, vp, vp, ctypes.c_float, vp, vp, i32, vp, vp,
    ]
    lib.pgym_grouped_attention_bthd.restype = i32
    lib.pgym_rope_qk.argtypes = [
        vp, vp, vp, vp, vp, i32, i32, i32, i32, vp, vp, ctypes.c_float, vp,
    ]
    lib.pgym_rope_qk.restype = i32
    lib.pgym_cuda_error_string.argtypes = [i32]
    lib.pgym_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=64)
def _rope_tables(t: int, d: int, base: float, device: torch.device):
    cos_np, sin_np = _cos_sin_cache(t, d, base)
    return (torch.from_numpy(cos_np).to(device),
            torch.from_numpy(sin_np).to(device))


def _aligned_rows(x: torch.Tensor) -> bool:
    """Every (b, h, t) row starts on a 16-byte boundary, with strides that
    are positive multiples of 16 bytes (what a TMA tensor map and the
    float32 kernel's 16-byte cp.async copies of K and V take)."""
    per16 = 16 // x.element_size()
    return x.data_ptr() % 16 == 0 and all(s % per16 == 0 and s > 0 for s in x.stride()[:3])


def _checked_qkv(q, k, v):
    """Raise for what the attention kernels do not take; return q/k/v with
    views that are not aligned for 16-byte loads copied."""
    b, h, t, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"the attention kernel takes float32 or bfloat16 q/k/v of one "
            f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    dims = HEAD_DIMS if q.dtype == torch.bfloat16 else F32_HEAD_DIMS
    if d not in dims:
        raise ValueError(f"head dim {d} not supported by the {q.dtype} attention kernel "
                         f"(supported: {dims})")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q/k/v must lie on one device")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the attention kernel needs a unit head-dim stride")
    # both kernels read rows with 16-byte loads; a view that is not aligned
    # for them is copied to a fresh contiguous tensor first
    return tuple(x if _aligned_rows(x) else x.clone(memory_format=torch.contiguous_format)
                 for x in (q, k, v))


def _refuse_autograd(entry: str, plain: str, *tensors) -> None:
    """Raise when grad mode is on and a tensor requires a gradient: the
    kernel behind ``entry`` has no backward."""
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in tensors):
        raise RuntimeError(
            f"{entry} has no backward (its kernel writes through raw pointers, so its "
            f"output would carry no gradient); under autograd call its plain version, "
            f"flash_attention.{plain}, which is differentiable")


def _strides(q, k, v, out):
    """The first three strides of each tensor, 12 int64 values."""
    return (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )


def _ptr(x):
    return None if x is None else x.data_ptr()


def rope_qk(q: torch.Tensor, k: torch.Tensor, sm_scale: float = 1.0,
            rope_base: Optional[float] = None):
    """The Hopper loop's pre-pass alone: q' = rope(q * sm_scale) and k' =
    rope(k) on (B, H, T, D) tensors, each step rounded to the input dtype
    as ``plain_rope_qk`` rounds. CUDA tensors (bfloat16) launch the kernel,
    which writes (B, T, H, D) memory returned as (B, H, T, D) views (k
    itself when there is no rotation); CPU tensors take ``plain_rope_qk``.
    The attention entries run the same kernel inside their own launch."""
    _refuse_autograd("rope_qk", "plain_rope_qk", q, k)
    if q.device.type == "cpu":
        return plain_rope_qk(q, k, sm_scale, rope_base)
    if q.device.type != "cuda":
        raise ValueError(f"no pre-pass for device {q.device}")
    q, k, _ = _checked_qkv(q, k, k)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the pre-pass takes bfloat16 q/k, got {q.dtype}")
    b, h, t, d = q.shape
    q_out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    k_out = torch.empty_like(q_out) if rope_base is not None else None
    cos = sin = None
    if rope_base is not None:
        cos, sin = _rope_tables(t, d, float(rope_base), q.device)
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        err = lib.pgym_rope_qk(
            q.data_ptr(), k.data_ptr(), q_out.data_ptr(), _ptr(k_out),
            (ctypes.c_longlong * 6)(*q.stride()[:3], *k.stride()[:3]), b, h, t, d,
            _ptr(cos), _ptr(sin), float(sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError("rope_qk launch failed: " + lib.pgym_cuda_error_string(err).decode())
    LAUNCHES["rope_qk"] += 1
    return q_out.permute(0, 2, 1, 3), (k_out.permute(0, 2, 1, 3) if k_out is not None else k)


def _key_tile_extents(b, t, segment_ids, key_mask, causal, device):
    """The key tiles [lo, hi) (KERNEL_TILE keys each) that each Q_TILE-row
    query tile of the Hopper loop visits, both (B, ceil(T / Q_TILE)) int32
    on ``device``; None when every tile is visited (neither segments nor
    causal).

    With segments, a query tile visits the tiles from the start of the
    first run it touches to the end of the last. That covers every key of
    its segments when each live id (> 0) forms one run; a row whose live
    ids do not rise from run to run (an id may come back) visits every
    tile. Causal calls stop at the diagonal tile, except that a tile
    holding a row with no live key at or before it (a ``key_mask`` without
    segments) visits every tile, so that row averages v over all T keys as
    the plain version does."""
    if segment_ids is None and not causal:
        return None
    dev = torch.device(device)
    n_qt, n_kt = -(-t // Q_TILE), -(-t // KERNEL_TILE)
    q0 = torch.arange(n_qt, device=dev) * Q_TILE
    if segment_ids is not None:
        seg = F.pad(segment_ids.to(dev), (0, n_qt * Q_TILE - t))
        lo, hi = _segment_block_extents(seg, n_qt, Q_TILE, KERNEL_TILE)
        lo, hi = lo.long(), hi.long().clamp(max=n_kt)
        # a run whose live id is not above every id before it: the id may
        # have come before, so the row visits every tile
        ids = seg.long()
        before = F.pad(torch.cummax(ids, dim=1).values[:, :-1], (1, 0))
        starts = ids != F.pad(ids[:, :-1], (1, 0))
        repeats = ((ids > 0) & starts & (ids <= before)).any(dim=1, keepdim=True)
        lo = lo.masked_fill(repeats, 0)
        hi = hi.masked_fill(repeats, n_kt)
    else:
        lo = torch.zeros(b, n_qt, dtype=torch.long, device=dev)
        hi = torch.full((b, n_qt), n_kt, dtype=torch.long, device=dev)
    if causal:
        diag = (q0 + Q_TILE).clamp(max=t).sub(1).div(KERNEL_TILE, rounding_mode="floor") + 1
        diag = diag[None].expand(b, n_qt)
        if segment_ids is None and key_mask is not None:
            live = key_mask.to(dev, torch.bool)
            first = torch.where(live.any(dim=1), live.int().argmax(dim=1), t)
            diag = torch.where(first[:, None] > q0[None], n_kt, diag)
        hi = torch.minimum(hi, diag)
    return lo.int().contiguous(), hi.int().contiguous()


class KeyTiles:
    """The key-tile extents of one (``segment_ids``, ``key_mask``,
    ``causal``) triple, computed by the first bfloat16 launch of the
    Hopper loop that takes them and kept for the next ones. A model makes
    one per forward where it makes the masks and passes it, with the same
    mask tensors, to every layer (PoET's twelve self-tier calls share
    one): the extents cost some forty small device ops of host time."""

    def __init__(self, segment_ids=None, key_mask=None, causal=False):
        self.segment_ids, self.key_mask, self.causal = segment_ids, key_mask, bool(causal)
        self._extents = {}

    def extents(self, b, t, device):
        key = (b, t, str(device))
        if key not in self._extents:
            self._extents[key] = _key_tile_extents(b, t, self.segment_ids, self.key_mask,
                                                   self.causal, device)
        return self._extents[key]

    def check(self, segment_ids, key_mask, causal):
        """Raise unless these are the masks the extents were made for."""
        if (segment_ids is not self.segment_ids or key_mask is not self.key_mask
                or bool(causal) != self.causal):
            raise ValueError("key_tiles were made for other segment_ids, key_mask or causal")


def _launch_grouped_attention(q, k, v, key_mask, bias, causal, sm_scale,
                              rope_base, segment_ids, key_tiles, bthd=False,
                              counter="grouped_attention"):
    """Launch the grouped kernel on (B, H, T, D) tensors, or with ``bthd``
    its (B, T, H, D) entry (no bias) on (B, T, H, D) tensors; the result
    comes in the same layout. bfloat16 runs the pre-pass (when there is
    RoPE or a scale) and the Hopper loop with key-tile extents, in one
    foreign call; float32 the 3xTF32 kernel, which rotates and scales on
    load. The launch is counted under ``counter`` (the wrapper's TPU
    kernel), plus ``rope_qk`` when the pre-pass ran."""
    q, k, v = _checked_qkv(q, k, v)
    if bthd:
        b, t, h, d = q.shape
    else:
        b, h, t, d = q.shape
    dev = q.device
    # (B, T, H, D) memory, seen as (B, H, T, D) by the (B, H, T, D) entry:
    # the model's output projection reads it back without a transpose
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=dev)
    if not bthd:
        out = out.permute(0, 2, 1, 3)
    for name, x, shape in (("key_mask", key_mask, (b, t)), ("bias", bias, (h, t)),
                           ("segment_ids", segment_ids, (b, t))):
        if x is not None and x.shape != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    lo = hi = scratch = cos = sin = None
    if q.dtype == torch.bfloat16 and (segment_ids is not None or causal):
        # from the caller's tensors, before the lines below convert them
        tiles = key_tiles or KeyTiles(segment_ids, key_mask, causal)
        lo, hi = tiles.extents(b, t, dev)
    if key_mask is not None:
        key_mask = key_mask.to(device=dev, dtype=torch.bool).contiguous()
    if bias is not None:
        bias = bias.to(device=dev, dtype=torch.float32).contiguous()
    if segment_ids is not None:
        segment_ids = segment_ids.to(device=dev, dtype=torch.int32).contiguous()
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if rope_base is not None:
        cos, sin = _rope_tables(t, d, float(rope_base), dev)
    prepass = q.dtype == torch.bfloat16 and (rope_base is not None or sm_scale != 1.0)
    if prepass:  # q' and, with RoPE, k' after it
        scratch = torch.empty((2 if rope_base is not None else 1) * b * t * h * d,
                              dtype=q.dtype, device=dev)
    n_qt = 0 if lo is None else lo.shape[1]

    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if bthd:
            err = lib.pgym_grouped_attention_bthd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _strides(q, k, v, out),
                b, h, t, d, _DTYPE_CODES[q.dtype], _ptr(key_mask),
                _ptr(segment_ids), int(bool(causal)), _ptr(cos), _ptr(sin),
                float(sm_scale), _ptr(lo), _ptr(hi), n_qt, _ptr(scratch), stream,
            )
        else:
            err = lib.pgym_grouped_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _strides(q, k, v, out), b, h, t, d, _DTYPE_CODES[q.dtype],
                _ptr(key_mask), _ptr(bias), _ptr(segment_ids), int(bool(causal)),
                _ptr(cos), _ptr(sin), float(sm_scale), _ptr(lo), _ptr(hi), n_qt,
                _ptr(scratch), stream,
            )
    if err != 0:
        raise RuntimeError(f"{counter} launch failed: "
                           + lib.pgym_cuda_error_string(err).decode())
    LAUNCHES[counter] += 1
    if prepass:
        LAUNCHES["rope_qk"] += 1
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
    key_tiles: Optional[KeyTiles] = None,
) -> torch.Tensor:
    """Fused attention, (B, H, T, D) -> (B, H, T, D). CUDA tensors launch the
    Hopper kernel (any T; head dims in HEAD_DIMS for bfloat16, in
    F32_HEAD_DIMS for float32, whose 3xTF32 products keep float32's
    accuracy); CPU tensors take the plain version. With ``rope_base`` q/k
    arrive unrotated.
    ``sm_scale`` None means 1/sqrt(D); 1.0 when the caller pre-scaled q.

    ``segment_ids`` (B, T) int >= 0, 0 = padding. Rows of live ids (> 0)
    get exact segmented attention; padding rows are finite but are not the
    plain version's. The bfloat16 kernel skips the key tiles outside each
    query tile's segment runs; a batch row whose live ids do not rise from
    run to run (an id that forms two runs) visits every tile, so any ids
    are honoured, contiguous runs are fast. ``key_tiles``: the extents of
    these masks (a ``KeyTiles`` made from these very tensors), shared by
    the calls of one forward; None computes them for this call."""
    _refuse_autograd("grouped_mha", "plain_mha", q, k, v, bias)
    if key_tiles is not None:
        key_tiles.check(segment_ids, key_mask, causal)
    if q.device.type == "cuda":
        return _launch_grouped_attention(q, k, v, key_mask, bias, causal,
                                         sm_scale, rope_base, segment_ids, key_tiles)
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
    key_tiles: Optional[KeyTiles] = None,
) -> torch.Tensor:
    """Heads-mid attention: q/k/v and the result are (B, T, H, D), the
    layout of the q/k/v projections, so nothing is transposed. No bias (as
    the TPU kernel takes none). CUDA tensors launch the grouped kernel's
    (B, T, H, D) entry (any T, head dims in HEAD_DIMS for bfloat16 or
    F32_HEAD_DIMS for float32); CPU tensors take ``plain_mha_bthd``.

    ``key_mask``, ``segment_ids`` and ``key_tiles`` as in ``grouped_mha``:
    both masks are honoured (the TPU kernel drops the key mask when
    segments are given, relying on padding being segment 0; callers that
    keep that contract see no difference), padding rows are not the plain
    version's, and a batch row whose live ids do not rise from run to run
    visits every key tile."""
    _refuse_autograd("grouped_mha_bthd", "plain_mha_bthd", q, k, v)
    if key_tiles is not None:
        key_tiles.check(segment_ids, key_mask, causal)
    if q.device.type == "cuda":
        return _launch_grouped_attention(q, k, v, key_mask, None, causal, sm_scale,
                                         rope_base, segment_ids, key_tiles, bthd=True,
                                         counter="grouped_attention_bthd")
    if q.device.type == "cpu":
        return plain_mha_bthd(q, k, v, key_mask=key_mask, causal=causal,
                              sm_scale=sm_scale, rope_base=rope_base,
                              segment_ids=segment_ids)
    raise ValueError(f"no attention path for device {q.device}")


def flash_mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    key_tiles: Optional[KeyTiles] = None,
) -> torch.Tensor:
    """Long-context fused attention, (B, H, T, D) -> (B, H, T, D), q/k
    already rotated (PoET's multi tier). CUDA tensors launch the grouped
    kernel's (B, H, T, D) entry with ``key_mask``, the (H, T) ``bias`` and
    ``causal`` as their own operands and no RoPE: for bfloat16 the pre-pass
    only scales q (the JAX wrapper's ``bf16(q * sm_scale)``) and the Hopper
    loop stops causal calls at the diagonal, except that a query tile
    holding a row with no live key at or before it visits every tile, so
    that row averages v over all T keys as the plain version does. Any T,
    head dims in HEAD_DIMS (bfloat16) or F32_HEAD_DIMS (float32); counted under
    ``flash_attention``. CPU tensors take ``reference_mha``. ``key_tiles``
    as in ``grouped_mha``."""
    _refuse_autograd("flash_mha", "reference_mha", q, k, v, bias)
    if key_tiles is not None:
        key_tiles.check(None, key_mask, causal)
    if q.device.type == "cuda":
        return _launch_grouped_attention(q, k, v, key_mask, bias, causal, sm_scale, None,
                                         None, key_tiles, counter="flash_attention")
    if q.device.type == "cpu":
        return reference_mha(q, k, v, key_mask=key_mask, bias=bias,
                             causal=causal, sm_scale=sm_scale)
    raise ValueError(f"no attention path for device {q.device}")


def _segment_block_extents(segment_ids: torch.Tensor, n_qb: int,
                           block: int, key_block: Optional[int] = None):
    """(B, T) contiguous segment ids, T = n_qb * block -> per-query-block
    key-block extents [lo, hi) in ``key_block`` units (default ``block``),
    both (B, n_qb) int32, on the ids' device: the first key block holding
    the start of any segment the query block touches, and one past the key
    block holding the last end. The Hopper loop takes blocks of Q_TILE
    query rows and key blocks of KERNEL_TILE."""
    key_block = key_block or block
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
    lo = start_tok.view(b, n_qb, block).amin(dim=-1) // key_block
    hi = end_tok.view(b, n_qb, block).amax(dim=-1) // key_block + 1
    return lo.int(), hi.int()


def seg_block_mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
    rope_base: Optional[float] = None,
    key_tiles: Optional[KeyTiles] = None,
) -> torch.Tensor:
    """Extent-sparse block-diagonal attention for segment-packed rows,
    (B, H, T, D) -> (B, H, T, D). ``segment_ids`` (B, T) int, 0 = padding;
    ``key_mask`` (B, T) as in ``grouped_mha``; no bias or causal mask.
    Live queries get dense segmented attention to the live keys of their
    segment; padding queries compute values that callers never consume.
    With ``rope_base`` q/k arrive unrotated; ``sm_scale`` None means
    1/sqrt(D). ``key_tiles`` as in ``grouped_mha``.

    CUDA tensors launch the grouped kernel's (B, H, T, D) entry, counted
    under ``seg_block_attention``: for bfloat16 the pre-pass rotates and
    scales q/k and the Hopper loop visits only the key tiles that share a
    segment with each query tile (a warpgroup of 64 rows skips those that
    share none with its own rows); float32 takes the 3xTF32 kernel (any
    T, head dims in F32_HEAD_DIMS). CPU tensors take ``plain_seg_block_mha``. The
    JAX kernel needs T to be a multiple of its 128-row block; neither
    version here does.

    Rounding order: the pre-pass scales q, rounds it to bf16, then
    rotates; the plain version (the JAX wrapper's order) rotates first and
    scales after. The two agree bit for bit when ``sm_scale`` is 1 (ESM
    pre-scales q) and within one bf16 rounding of q otherwise."""
    _refuse_autograd("seg_block_mha", "plain_seg_block_mha", q, k, v)
    if key_tiles is not None:
        key_tiles.check(segment_ids, key_mask, False)
    if q.device.type == "cuda":
        return _launch_grouped_attention(q, k, v, key_mask, None, False, sm_scale, rope_base,
                                         segment_ids, key_tiles, counter="seg_block_attention")
    if q.device.type == "cpu":
        return plain_seg_block_mha(q, k, v, segment_ids, key_mask=key_mask,
                                   sm_scale=sm_scale, rope_base=rope_base)
    raise ValueError(f"no attention path for device {q.device}")


def mha(q, k, v, key_mask=None, bias=None, causal=False, sm_scale=None,
        rope_base=None, segment_ids=None, key_tiles=None):
    """Attention dispatch, as the JAX ``mha`` routes on a TPU:

    - T <= GROUPED_MAX_SEQ_LEN: ``grouped_mha`` (RoPE fused);
    - longer, without ``segment_ids``: RoPE in-graph when ``rope_base`` is
      set, then the long-context ``flash_mha``;
    - longer, with ``segment_ids``, no bias and not causal (ESM's packed
      rows): the extent-sparse ``seg_block_mha``, with ``key_mask`` as its
      own operand (the JAX dispatch folds it into the ids and pads T to a
      multiple of 128; live rows see the same keys either way);
    - longer, with ``segment_ids`` and causal or a bias (PoET's self tier):
      ``grouped_mha``, which has no context cap here. The JAX package takes
      its dense XLA path there, which computes the same function.

    ``key_tiles`` (see ``KeyTiles``) goes to the wrapper taken, with the
    caller's own mask tensors. Each wrapper runs its plain version on CPU
    tensors, so the routing is the same on both devices."""
    if q.shape[2] <= GROUPED_MAX_SEQ_LEN or (
            segment_ids is not None and (causal or bias is not None)):
        return grouped_mha(q, k, v, key_mask=key_mask, bias=bias, causal=causal,
                           sm_scale=sm_scale, rope_base=rope_base,
                           segment_ids=segment_ids, key_tiles=key_tiles)
    if segment_ids is None:
        if rope_base is not None:
            q, k = apply_rotary_bhtd(q, k, rope_base)
        return flash_mha(q, k, v, key_mask=key_mask, bias=bias, causal=causal,
                         sm_scale=sm_scale, key_tiles=key_tiles)
    return seg_block_mha(q, k, v, segment_ids, key_mask=key_mask, sm_scale=sm_scale,
                         rope_base=rope_base, key_tiles=key_tiles)


def mha_natural(q, k, v, key_mask=None, bias=None, causal=False,
                sm_scale=None, rope_base=None, segment_ids=None, key_tiles=None):
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
                                segment_ids=segment_ids, key_tiles=key_tiles)
    tr = lambda x: x.transpose(1, 2)
    return tr(mha(tr(q), tr(k), tr(v), key_mask=key_mask, bias=bias,
                  causal=causal, sm_scale=sm_scale, rope_base=rope_base,
                  segment_ids=segment_ids, key_tiles=key_tiles))
