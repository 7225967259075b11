"""Layer norm of bfloat16 activations with float32 statistics and affine,
and the same norm with the residual add before it fused in: the
hand-written kernel of ``csrc/layer_norm.cu`` and its plain versions.

It replaces no TPU kernel: the JAX package's norm is plain jnp, which XLA
fuses with its casts into one pass. Eagerly, ``plain_layer_norm`` is three
passes (the float32 copy, ``F.layer_norm``, the cast back; 20 B an
element) and the add before it a fourth; the kernel reads each bf16 row
once and writes it once (4 B an element, 8 with the add).

``takes_kernel`` is the dispatch rule of the models' ``esm2.LayerNorm``:
bfloat16 on CUDA in rows the kernel's 16-byte vectors fit (a width that is
a multiple of 8, every tensor's data 16-byte aligned, as the allocator
leaves it), with no tensor that autograd needs. Everything else (the CPU,
float32 trunks, training, an unaligned view) keeps the plain version. The
kernel has no backward. Its launches are counted in ``LAUNCHES`` (both
entries under ``layer_norm``), each one's host side in the span
``pgym.launch.layer_norm``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F

from proteingym_tpu_torch.pipeline.profiler import span

EPS = 1e-5
LAUNCHES = {"layer_norm": 0}
LAUNCH_SPAN = "pgym.launch.layer_norm"


def plain_layer_norm(x, weight, bias, eps=EPS):
    """Layer norm of ``x`` computed in float32 with float32 ``weight`` and
    ``bias``, returned in ``x``'s dtype."""
    return F.layer_norm(x.float(), weight.shape, weight, bias, eps).to(x.dtype)


def plain_add_layer_norm(x, delta, weight, bias, eps=EPS):
    """(x + delta, its layer norm): the sum in the inputs' dtype, then
    ``plain_layer_norm``."""
    s = x + delta
    return s, plain_layer_norm(s, weight, bias, eps)


def takes_kernel(x, *others) -> bool:
    """True for a bfloat16 CUDA ``x`` of a width that is a multiple of 8,
    the data of ``x`` and ``others`` (the norm's parameters, the residual)
    16-byte aligned, when autograd needs none of them."""
    return (x.is_cuda and x.dtype == torch.bfloat16 and x.shape[-1] % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, *others))
            and not (torch.is_grad_enabled()
                     and (x.requires_grad or any(t.requires_grad for t in others))))


@functools.lru_cache(maxsize=1)
def _kernel_lib():
    from proteingym_tpu_torch.ops._build import load_library

    lib = load_library("layer_norm")
    vp = ctypes.c_void_p
    lib.pgym_layer_norm.argtypes = [vp, vp, vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_float, vp]
    lib.pgym_layer_norm.restype = ctypes.c_int
    lib.pgym_layer_norm_error_string.argtypes = [ctypes.c_int]
    lib.pgym_layer_norm_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, delta, weight, bias, eps):
    with span(LAUNCH_SPAN):
        d = x.shape[-1]
        if x.dtype != torch.bfloat16 or not x.is_cuda or d % 8:
            raise ValueError(f"the layer-norm kernel takes a bfloat16 CUDA tensor of a width "
                             f"that is a multiple of 8, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
        if (weight.dtype != torch.float32 or bias.dtype != torch.float32
                or weight.shape != (d,) or bias.shape != (d,)):
            raise ValueError(f"the layer-norm kernel takes float32 ({d},) weight and bias, got "
                             f"{weight.dtype} {tuple(weight.shape)} and {bias.dtype} "
                             f"{tuple(bias.shape)}")
        if weight.device != x.device or bias.device != x.device:
            raise ValueError("x, weight and bias must lie on one device")
        if delta is not None and (delta.shape != x.shape or delta.dtype != x.dtype
                                  or delta.device != x.device):
            raise ValueError(f"delta must match x {tuple(x.shape)} {x.dtype}, got "
                             f"{tuple(delta.shape)} {delta.dtype} on {delta.device}")
        x, weight, bias = x.contiguous(), weight.contiguous(), bias.contiguous()
        if delta is not None:
            delta = delta.contiguous()
        y = torch.empty_like(x)
        s = None if delta is None else torch.empty_like(x)
        lib = _kernel_lib()
        dev = x.device
        # no device switch when x lies on the current device (the main path)
        with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
              else torch.cuda.device(dev)):
            err = lib.pgym_layer_norm(
                x.data_ptr(), None if delta is None else delta.data_ptr(), weight.data_ptr(),
                bias.data_ptr(), y.data_ptr(), None if s is None else s.data_ptr(),
                x.numel() // d, d, eps, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"layer_norm launch failed (width {d}): "
                               + lib.pgym_layer_norm_error_string(err).decode())
        LAUNCHES["layer_norm"] += 1
    return y if s is None else (s, y)


def layer_norm(x, weight, bias, eps=EPS):
    """``plain_layer_norm`` in one launch of the kernel: ``x`` a bfloat16
    CUDA tensor (..., d), d a multiple of 8, ``weight`` and ``bias``
    float32 (d,), each 16-byte aligned (``takes_kernel``); returns a new
    contiguous bfloat16 tensor. It has no backward."""
    return _launch(x, None, weight, bias, eps)


def add_layer_norm(x, delta, weight, bias, eps=EPS):
    """``plain_add_layer_norm`` in one launch of the kernel: ``x`` and
    ``delta`` bfloat16 CUDA tensors of one shape; returns (x + delta, its
    norm), the sum bit for bit the bf16 add's. It has no backward."""
    return _launch(x, delta, weight, bias, eps)
