"""The supervised baselines in PyTorch: one-hot and embedding ridges over
the published CV folds (counterpart of
proteingym_tpu/models/supervised_baselines.py).

The supervised leaderboard reads score files of the ProteinNPT repo's
baselines (OHE ridge, embedding ridge, ProteinNPT) and Kermut; this module
trains the ridges per assay and returns per-scheme out-of-fold predictions
in the ``scores_root/<cv_scheme>/<location>/<DMS_id>.csv`` layout that
merge/supervised.py reads.

Folds come from the assay's ``fold_random_5`` / ``fold_modulo_5`` /
``fold_contiguous_5`` columns when it has them, otherwise from the
constructions the JAX package uses (``RandomState(42)`` for the random
scheme, so the folds are equal). The ridge solves (X^T X + lam I) w =
X^T y by a float32 Cholesky per fold on the device.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from proteingym_tpu_torch.data.table import Table, parse_numeric, read_csv
from proteingym_tpu_torch.metrics.aggregate import group_mean

AA20 = "ACDEFGHIKLMNPQRSTVWY"
CV_SCHEMES = ["fold_random_5", "fold_modulo_5", "fold_contiguous_5"]


def onehot_features(mutated_sequences: Sequence[str], seq_len: int) -> np.ndarray:
    """(N, L*20) flattened one-hots (the ProteinNPT OHE baseline input)."""
    aa_idx = {a: i for i, a in enumerate(AA20)}
    out = np.zeros((len(mutated_sequences), seq_len, 20), np.float32)
    for i, s in enumerate(mutated_sequences):
        for j, c in enumerate(s[:seq_len]):
            k = aa_idx.get(c)
            if k is not None:
                out[i, j, k] = 1.0
    return out.reshape(len(mutated_sequences), -1)


def assign_folds(mutants: Sequence[str], scheme: str, n_folds: int = 5, seed: int = 42,
                 seq_len: Optional[int] = None) -> np.ndarray:
    """Fold ids per variant for the three published CV constructions."""
    n = len(mutants)
    if scheme == "fold_random_5":
        return np.random.RandomState(seed).randint(0, n_folds, n)

    def first_pos(m):
        try:
            return int(m.split(":")[0][1:-1])
        except (ValueError, IndexError):
            return 0

    positions = np.asarray([first_pos(m) for m in mutants])
    if scheme == "fold_modulo_5":
        return positions % n_folds
    if scheme == "fold_contiguous_5":
        lo, hi = positions.min(), positions.max() + 1
        edges = np.linspace(lo, hi, n_folds + 1)
        return np.clip(np.searchsorted(edges, positions, "right") - 1, 0, n_folds - 1)
    raise ValueError(f"Unknown CV scheme {scheme}")


def ridge_solve(x: torch.Tensor, y: torch.Tensor, lam: float) -> torch.Tensor:
    """w of (X^T X + lam I) w = X^T y, float32 Cholesky."""
    gram = x.T @ x + lam * torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
    chol = torch.linalg.cholesky(gram)
    return torch.cholesky_solve((x.T @ y)[:, None], chol)[:, 0]


@torch.no_grad()
def ridge_cv_predict(features: np.ndarray, y: np.ndarray, folds: np.ndarray, lam: float = 1.0,
                     device="cuda") -> np.ndarray:
    """Out-of-fold predictions: per fold, the ridge of the other folds
    (centred on the assay's mean score) predicts the held-out variants."""
    x = torch.as_tensor(np.asarray(features, np.float32), device=device)
    yt = torch.as_tensor(np.asarray(y, np.float32), device=device)
    y_mean = float(np.mean(y))
    out = np.zeros(len(y))
    for fold in np.unique(folds):
        test = torch.as_tensor(np.nonzero(folds == fold)[0], device=x.device)
        train = torch.as_tensor(np.nonzero(folds != fold)[0], device=x.device)
        w = ridge_solve(x[train], yt[train] - y_mean, lam)
        out[(folds == fold)] = (x[test] @ w + y_mean).cpu().numpy()
    return out


@torch.no_grad()
def esm_embedding_features(model, mutated_sequences: Sequence[str], batch_size: int = 16
                           ) -> np.ndarray:
    """(N, D) float32 mean-pooled final-layer ESM embeddings (the embedding
    ridge's input): every row padded to the assay's longest, the mean over
    every token that is not PAD, so BOS and EOS are in it, as in the JAX
    package."""
    from proteingym_tpu_torch.models import esm2

    pad = esm2.ALPHABET.padding_idx
    rows = [esm2.ALPHABET.tokenize(s) for s in mutated_sequences]
    t = max(len(r) for r in rows)
    dev = model.embed_tokens.weight.device
    feats = []
    for s in range(0, len(rows), batch_size):
        blk = rows[s:s + batch_size]
        toks = np.full((len(blk), t), pad, np.int64)
        for bi, r in enumerate(blk):
            toks[bi, :len(r)] = r
        tokens = torch.as_tensor(toks, device=dev)
        _, reps = model(tokens, return_representations=True)
        feats.append(mean_pool(reps[max(reps)].float(), tokens, pad).cpu().numpy())
    return np.concatenate(feats, 0)


def mean_pool(final: torch.Tensor, tokens: torch.Tensor, pad: int) -> torch.Tensor:
    """(B, T, D) -> (B, D): the mean over each row's tokens that are not
    ``pad``."""
    mask = (tokens != pad)[..., None]
    return (final * mask).sum(1) / mask.sum(1).clamp(min=1)


def make_embedding_feature_fn(checkpoint, batch_size: int = 16, device="cuda"):
    """The ESM trunk of a --checkpoint spec (``esm2_t6_8M`` without one) and
    the mean-pooled embedding feature function over it."""
    from proteingym_tpu_torch.devices import no_tf32
    from proteingym_tpu_torch.pipeline.checkpoints import load_esm_checkpoint

    model, _ = load_esm_checkpoint(checkpoint or "esm2_t6_8M", device=device)

    def feature_fn(seqs):
        with no_tf32():
            return esm_embedding_features(model, seqs, batch_size=batch_size)
    return feature_fn


def load_aug_scores(mutants: Sequence[str], scores_csv, col: Optional[str] = None) -> np.ndarray:
    """A zero-shot score file joined onto the assay's mutants: ``col`` (the
    last non-key column by default), duplicate mutants averaged (pandas'
    ``groupby().mean()``), a mutant the file lacks NaN. Raises when no
    mutant matches."""
    scores = read_csv(scores_csv)
    if col is None:
        col = [c for c in scores.names if c not in ("mutant", "mutated_sequence", "DMS_score")][-1]
    values = parse_numeric(scores[col]).astype(np.float64)
    keys, means = group_mean(values, [(m,) for m in scores["mutant"].tolist()])
    mean_of = {k[0]: v for k, v in zip(keys, means[:, 0])}
    aux = np.asarray([mean_of.get(m, np.nan) for m in mutants], np.float64)
    if np.isnan(aux).all():
        raise ValueError(f"aug scores {str(scores_csv)!r}: no mutants matched the assay (column "
                         f"{col!r}) — check the file and its mutant naming")
    return aux


def standardized_aux(aux: np.ndarray) -> np.ndarray:
    """NaN filled with the mean (with a warning), then (x - mean) / (std +
    1e-8)."""
    aux = np.asarray(aux, np.float64)
    n_missing = int(np.isnan(aux).sum())
    if n_missing == len(aux):
        raise ValueError("aux zero-shot scores are all-NaN — nothing to augment with")
    if n_missing:
        warnings.warn(f"aux scores: {n_missing}/{len(aux)} NaN; filling with the mean "
                      "zero-shot score")
        aux = np.where(np.isnan(aux), np.nanmean(aux), aux)
    return (aux - aux.mean()) / (aux.std() + 1e-8)


def run_supervised_baseline(
    assay: Table,
    target_seq: str,
    model: str = "OHE_ridge",
    cv_schemes: Sequence[str] = tuple(CV_SCHEMES),
    lam: float = 1.0,
    seed: int = 42,
    feature_fn: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
    aux: Optional[np.ndarray] = None,
    npt_config=None,
    device="cuda",
) -> Dict[str, Table]:
    """Train and predict out of fold one assay (a ``Table`` with ``mutant``,
    ``DMS_score``, optionally ``mutated_sequence`` and fold columns) for
    every CV scheme. ``aux``, a zero-shot score per variant, is appended
    standardised as one more ridge feature (the 'Augmented' recipes) or fed
    to ProteinNPT as its auxiliary token; ProteinNPT without one takes the
    assay's ``zero_shot_score`` or ``Tranception_score`` column. Returns
    {scheme: Table(mutant, y_pred, DMS_score)}."""
    mutants = assay["mutant"].tolist()
    seqs = (assay["mutated_sequence"] if "mutated_sequence" in assay else assay["mutant"]).tolist()
    y = assay.floats("DMS_score")
    npt = model.lower() in ("proteinnpt", "protein_npt")
    if aux is None and npt:
        for col in ("zero_shot_score", "Tranception_score"):
            if col in assay:
                aux = assay.floats(col)
                break
    if aux is not None:
        aux = standardized_aux(aux)
    if npt:
        from proteingym_tpu_torch.models.protein_npt import npt_cv_predict, residue_features

        features = residue_features(seqs, len(target_seq))
    elif feature_fn is not None:
        features = feature_fn(seqs)
    elif model == "OHE_ridge":
        features = onehot_features(seqs, len(target_seq))
    else:
        raise ValueError(f"Unknown baseline {model} without feature_fn")
    if aux is not None and not npt:
        features = np.concatenate([np.asarray(features, np.float32),
                                   aux[:, None].astype(np.float32)], axis=1)
    out = {}
    for scheme in cv_schemes:
        folds = (parse_numeric(assay[scheme]) if scheme in assay
                 else assign_folds(mutants, scheme, seed=seed))
        if npt:
            preds = npt_cv_predict(features, y, folds, c=npt_config, aux=aux, seed=seed,
                                   device=device)
        else:
            preds = ridge_cv_predict(features, y, folds, lam=lam, device=device)
        out[scheme] = Table({"mutant": np.asarray(mutants, dtype=object), "y_pred": preds,
                             "DMS_score": y})
    return out
