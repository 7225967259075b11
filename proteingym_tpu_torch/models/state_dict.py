"""Loading published checkpoints by name: ``Named``, a container whose
children take a checkpoint's own names, and ``copy_state_dict``, which
fills a model's tensors from the same-named entries of a state dict. Every
model module of the port loads through them.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


class Named(nn.Module):
    """A container whose children take the names a published checkpoint
    gives them (``Named(dense=..., LayerNorm=...)``; a child may be named
    ``self``), so its state dict loads by name."""

    def __init__(module, /, **children):
        super().__init__()
        for name, child in children.items():
            setattr(module, name, child)


@torch.no_grad()
def copy_state_dict(model: nn.Module, state_dict: Mapping, name: str) -> nn.Module:
    """Copy each of the model's tensors from the same-named entry of
    ``state_dict`` (tensors or numpy arrays, taken through float32). Entries
    the model does not hold are ignored; one it needs and does not find, or
    one of another shape, raises (``name`` labels the checkpoint)."""
    for key, param in model.state_dict().items():
        if key not in state_dict:
            raise KeyError(f"checkpoint for {name} lacks {key!r}")
        value = state_dict[key]
        if not torch.is_tensor(value):
            value = torch.from_numpy(np.asarray(value, dtype=np.float32))
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(value.shape)}, "
                             f"model shape {tuple(param.shape)}")
        param.copy_(value.to(device=param.device, dtype=torch.float32))
    return model
