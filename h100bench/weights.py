"""Weights drawn from the seed on the device: a few large draws from one
``torch.Generator``, in the dtype each tensor is served in, split into
views that carry a published name."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one use (``stream``) of a run's seed;
    any whole number is a seed."""
    state = np.random.SeedSequence((abs(int(seed)), int(seed < 0), stream))
    return torch.Generator(device=device).manual_seed(int(state.generate_state(1, np.uint64)[0]))


def draw(specs: List[Tuple[str, tuple, str, str]], init: dict, seed: int,
         device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for (name, shape, dtype, init kind) ``specs``. Kinds:
    ``dense`` N(0, 1/fan_in) unless ``init['dense_std']`` fixes the std,
    ``embed`` / ``bias`` / ``ln_bias`` N(0, std^2) and ``ln_weight``
    1 + N(0, std^2), each std from ``init``. One draw per (dtype, kind)
    group, then a scale per dense fan-in."""
    gen = generator(seed, 1, device)
    groups: Dict[Tuple[str, str], List[Tuple[str, tuple]]] = {}
    for name, shape, dtype, kind in specs:
        groups.setdefault((dtype, kind), []).append((name, tuple(shape)))
    out: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        for (dtype, kind), members in groups.items():
            n = sum(math.prod(s) for _, s in members)
            flat = torch.randn(n, generator=gen, device=device, dtype=DTYPES[dtype])
            at = 0
            for name, shape in members:
                view = flat[at:at + math.prod(shape)].view(shape)
                at += math.prod(shape)
                if kind == "dense":
                    view.mul_(init.get("dense_std") or 1.0 / math.sqrt(shape[-1]))
                elif kind == "ln_weight":
                    view.mul_(init["ln_std"]).add_(1.0)
                else:
                    view.mul_(init[f"{kind}_std"])
                out[name] = view
    return out
