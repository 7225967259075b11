"""The device every public entry point of the port runs on: the card
unless the caller asks for the CPU."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``. A CUDA device that torch cannot
    see raises: the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r}, but torch sees no CUDA device; the port never "
            "falls back to the CPU on its own (pass --device cpu / device='cpu' for that)"
        )
    return dev


@contextlib.contextmanager
def no_tf32():
    """float32 products and convolutions in full float32 inside the block
    (cuBLAS and cuDNN without TF32), whatever the process has set, and the
    settings restored after it: the references are float32, so TF32 gives
    a different result, not a faster one."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def seeded_generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device``: seeded ``seed`` for stream 0, and for
    another ``stream`` from ``numpy.random.SeedSequence((seed, stream))``,
    so that two uses of one seed (a model's initial weights and its
    training, its training and its scoring) draw independent numbers, as
    the JAX package's split keys do."""
    if stream:
        seed = int(np.random.SeedSequence((seed, stream)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def adam(module: torch.nn.Module, learning_rate: float) -> torch.optim.Adam:
    """``torch.optim.Adam`` over the module's parameters, with the defaults
    and the update of ``optax.adam``; on the card its fused kernel."""
    params = list(module.parameters())
    return torch.optim.Adam(params, lr=learning_rate, fused=params[0].device.type == "cuda")
