"""The device every public entry point of the port runs on: the card
unless the caller asks for the CPU."""

from __future__ import annotations

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
