"""Scorer registry (counterpart of proteingym_tpu/pipeline/scorers.py):
``esm`` (masked marginals), ``poet`` (MSA-conditioned likelihood) and
``msa_transformer`` (MSA masked marginals in focus-column coordinates),
plus ``score_esm_packed_batch``, the cross-assay packed ESM path.

Each scorer is ``scorer(ctx: ScoreContext) -> {column: scores}``: the CLI
reads the assay, calls the scorer and writes the input columns plus the
returned score columns.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from proteingym_tpu_torch.data.mutants import is_wt_row, parse_mutant
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
    mutated_sequences: List[str] = dataclasses.field(default_factory=list)
    msa_dir: Optional[Path] = None
    weights_dir: Optional[Path] = None
    checkpoint: Optional[str] = None  # checkpoint path or preset name
    batch_size: int = 32
    extra: dict = dataclasses.field(default_factory=dict)
    _msa: object = dataclasses.field(default=None, init=False, repr=False)

    def load_msa(self, theta: Optional[float] = None):
        """Load and preprocess the assay's MSA, with sequence weights read
        from ``weights_dir/<weight_file_name>`` when its length matches the
        alignment, and otherwise computed on ``device`` and saved there as
        float64 ``.npy`` (the JAX package reads and writes the same file)."""
        if self._msa is not None:
            return self._msa
        from proteingym_tpu_torch.msa.parser import load_msa
        from proteingym_tpu_torch.msa.weights import sequence_weights

        if self.msa_dir is None or self.record.MSA_filename is None:
            raise FileNotFoundError(f"No MSA available for {self.record.DMS_id}")
        msa = load_msa(Path(self.msa_dir) / self.record.MSA_filename)
        theta = theta if theta is not None else (self.record.MSA_theta or 0.2)

        weights = None
        wpath = None
        if self.weights_dir is not None and self.record.weight_file_name:
            wpath = Path(self.weights_dir) / self.record.weight_file_name
            if wpath.exists():
                weights = np.load(wpath)
        if weights is None or len(weights) != msa.num_sequences:
            weights = sequence_weights(msa.matrix, theta=theta, device=self.device)
            if wpath is not None:
                wpath.parent.mkdir(parents=True, exist_ok=True)
                np.save(wpath, weights)
        self._msa = dataclasses.replace(msa, weights=weights)
        return self._msa


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


def score_esm_packed_batch(
    tasks: Sequence[Tuple[AssayRecord, Sequence[str]]],
    checkpoint: Optional[str],
    batch_size: int = 32,
    extra: Optional[dict] = None,
    device="cuda",
) -> Dict[str, Dict[str, np.ndarray]]:
    """Cross-assay packed ESM masked-marginal scoring, the path behind
    ``score --packed``.

    tasks: (AssayRecord, mutant strings) per assay. All assays' masked rows
    share forward batches of ``batch_size`` rows
    (models/packed_scoring.py); the scores equal the per-assay scorer's.
    Returns {DMS_id: {"<checkpoint name>_score": scores}}. ``--extra
    cols_per_forward=k`` opts into k-column masking (~1/k the forwards);
    k=1, the default, is the reference-exact protocol."""
    from proteingym_tpu_torch.models.packed_scoring import score_assays_packed
    from proteingym_tpu_torch.pipeline.checkpoints import load_esm_checkpoint

    extra = extra or {}
    if extra.get("ensemble") or extra.get("mesh"):
        raise ValueError(
            "--packed does not combine with ensemble/mesh scoring; run "
            "those per-assay"
        )
    if extra.get("scoring_strategy", "masked-marginals") != "masked-marginals":
        raise ValueError("--packed supports masked-marginals only")
    model, config = load_esm_checkpoint(checkpoint, device=device)
    scores = score_assays_packed(
        model, [(rec.target_seq, list(mutants)) for rec, mutants in tasks],
        chunk=batch_size, window=config.max_positions,
        cols_per_forward=int(extra.get("cols_per_forward", 1)),
    )
    return {rec.DMS_id: {f"{config.name}_score": s}
            for (rec, _), s in zip(tasks, scores)}


@register_scorer("poet")
def score_poet(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """PoET family-conditioned autoregressive scoring (ref
    PoET/scripts/score.py): log p(mutant | sampled MSA context), averaged
    over ``--extra n_context_samples=`` weighted context samples of at most
    ``max_context_tokens=`` tokens each."""
    from proteingym_tpu_torch.models.poet import score_assay_poet
    from proteingym_tpu_torch.pipeline.checkpoints import load_poet_checkpoint

    model, _ = load_poet_checkpoint(ctx.checkpoint, device=ctx.device)
    msa = ctx.load_msa()
    scores = score_assay_poet(
        model,
        ctx.mutated_sequences,
        msa.sequences(),
        msa.weights,
        max_context_tokens=int(ctx.extra.get("max_context_tokens", 4096)),
        n_context_samples=int(ctx.extra.get("n_context_samples", 2)),
        batch_size=ctx.batch_size,
    )
    return {"PoET_score": scores}


def _score_focus_model(ctx: ScoreContext, msa, score_fn, mutants) -> np.ndarray:
    """Remap DMS-coordinate mutants into trimmed-focus coordinates (through
    ``record.MSA_start`` and the MSA's focus columns) and run
    ``score_fn(wt_focus_seq, remapped_mutants)``. Literal wild-type rows
    score 0; a mutant outside the focus columns, with a wrong wild-type
    letter or malformed, is NaN."""
    msa_start = ctx.record.MSA_start or 1
    col_to_focus = {int(c): i for i, c in enumerate(np.asarray(msa.focus_cols))}
    wt = msa.focus_seq_trimmed.upper()
    remapped, valid = [], []
    for m in mutants:
        if is_wt_row(m):
            remapped.append("")
            valid.append(True)
            continue
        try:
            toks = []
            for f, pos, t in parse_mutant(m):
                fi = col_to_focus[pos - msa_start]
                if wt[fi] != f:
                    raise KeyError(m)
                toks.append(f"{f}{fi + 1}{t}")
        except (KeyError, ValueError, IndexError):
            valid.append(False)
            continue
        remapped.append(":".join(toks))
        valid.append(True)
    valid = np.asarray(valid, dtype=bool)
    out = np.full(len(mutants), np.nan)
    out[valid] = np.asarray(score_fn(wt, remapped))
    return out


@register_scorer("msa_transformer")
def score_msa_transformer(ctx: ScoreContext) -> Dict[str, np.ndarray]:
    """MSA Transformer ensemble masked marginals (ref
    esm/compute_fitness.py:355-400): ``--extra msa_samples=`` rows (384)
    sampled by sequence weight per seed, ``num_seeds=`` seeds (5),
    ``batch_size // 8`` grids per forward. The table is in trimmed
    focus-column coordinates, so mutants are remapped first."""
    from proteingym_tpu_torch.models.msa_transformer import score_assay_msa_transformer
    from proteingym_tpu_torch.pipeline.checkpoints import load_msa_transformer_checkpoint

    model, _ = load_msa_transformer_checkpoint(ctx.checkpoint, device=ctx.device)
    msa = ctx.load_msa()
    scores = _score_focus_model(
        ctx, msa,
        lambda wt, remapped: score_assay_msa_transformer(
            model, wt, remapped, msa.sequences(), msa.weights,
            nseq=int(ctx.extra.get("msa_samples", 384)),
            seeds=tuple(range(1, 1 + int(ctx.extra.get("num_seeds", 5)))),
            chunk=max(1, ctx.batch_size // 8),
        ),
        ctx.mutants,
    )
    return {"esm_msa1b_ensemble": scores}
