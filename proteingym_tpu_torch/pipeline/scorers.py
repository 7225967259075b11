"""Scorer registry (counterpart of proteingym_tpu/pipeline/scorers.py).

Each scorer is ``scorer(ctx: ScoreContext) -> {column: scores}``: the CLI
reads the assay, calls the scorer and writes the input columns plus the
returned score columns.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from proteingym_tpu_torch.data.reference import AssayRecord

SCORERS: Dict[str, Callable] = {}


def register_scorer(name: str):
    def deco(fn):
        SCORERS[name] = fn
        return fn
    return deco


@dataclasses.dataclass
class ScoreContext:
    """Everything a scorer needs for one (model, assay) task."""

    record: AssayRecord
    mutants: List[str]
    device: torch.device
    checkpoint: Optional[str] = None  # checkpoint path or preset name
    batch_size: int = 32
    extra: dict = dataclasses.field(default_factory=dict)


@register_scorer("esm")
def score_esm(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """ESM2/ESM-1v masked-marginal scoring.

    ``--extra ensemble=spec1,spec2,...`` scores each checkpoint and averages
    them (the ESM-1v 5-seed ensemble) into ``{name}_ensemble``; otherwise
    the single --checkpoint spec is scored into ``{name}_score``. Each spec
    follows load_esm_checkpoint."""
    from proteingym_tpu_torch.models.esm_scoring import score_assay
    from proteingym_tpu_torch.pipeline.checkpoints import load_esm_checkpoint

    specs = (
        str(ctx.extra["ensemble"]).split(",")
        if ctx.extra.get("ensemble") else [ctx.checkpoint]
    )
    per_member = []
    name = None
    for spec in specs:
        model, config = load_esm_checkpoint(spec, device=ctx.device)
        name = name or config.name
        per_member.append(score_assay(
            model,
            ctx.record.target_seq,
            ctx.mutants,
            strategy=ctx.extra.get("scoring_strategy", "masked-marginals"),
            chunk=ctx.batch_size,
            window=config.max_positions,
            device=ctx.device,
        ))
        del model  # one member's weights on the device at a time
    column = f"{name}_ensemble" if len(per_member) > 1 else f"{name}_score"
    return {column: np.mean(per_member, axis=0)}
