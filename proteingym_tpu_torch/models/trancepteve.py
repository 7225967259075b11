"""TranceptEVE and retrieval-augmented Tranception scoring (counterpart of
proteingym_tpu/models/trancepteve.py; ref trancepteve/score_trancepteve.py
and trancepteve/model_pytorch.py:666-1190):

1. the MSA log prior from the assay's alignment (weighted pseudocounts
   after the Hamming >= 0.2 filter);
2. the EVE log prior from an ensemble of EVE models (the log-space average
   of decoder draws at the WT latent);
3. alpha (MSA weight) and beta (EVE weight) from the filtered depth;
4. optionally both priors recalibrated to the transformer's mean WT
   log-prob;
5. mirrored teacher-forced passes whose shifted log-probs are fused with
   the priors inside the alignment's span.

Tranception with retrieval alone is the case beta = 0, alpha = 0.6.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from proteingym_tpu_torch.data.table import Table
from proteingym_tpu_torch.models import retrieval
from proteingym_tpu_torch.models.ar_scoring import score_mutants_ar
from proteingym_tpu_torch.models.tranception import VOCAB, Tranception


@dataclasses.dataclass
class RetrievalConfig:
    retrieval_type: str = "TranceptEVE"  # or "Tranception"
    msa_start: int = 0  # 0-indexed full-sequence coordinates
    msa_end: int = 0
    indel_mode: bool = False
    recalibrate: bool = False


@torch.no_grad()
def transformer_wt_mean_logprob(model: Tranception, target_seq: str, msa_start: int,
                                msa_end: int, n_special: int = 5) -> float:
    """The mean WT log-prob over the alignment's span and the amino-acid
    tokens, averaged over both reading directions (ref model_pytorch.py:
    889-892): the recalibration target. In the reversed pass shift
    position t predicts residue L-1-t, so [s, e) maps to [L-e, L-s)."""
    device = next(model.parameters()).device
    length = len(target_seq)
    means = []
    for seq, region in ((target_seq, slice(msa_start, msa_end)),
                        (target_seq[::-1], slice(length - msa_end, length - msa_start))):
        tokens = torch.from_numpy(VOCAB.tokenize(seq)[None]).long().to(device)
        logps = torch.log_softmax(model(tokens).float(), dim=-1)[0, :-1]
        means.append(float(logps[region, n_special:].mean()))
    return float(np.mean(means))


def build_priors(
    msa_sequences: Sequence[str],
    msa_weights: Optional[np.ndarray],
    target_seq: str,
    rcfg: RetrievalConfig,
    eve_models=None,
    eve_focus_cols: Optional[np.ndarray] = None,
    eve_focus_seq: Optional[str] = None,
    eve_num_samples: int = 20_000,
    model: Optional[Tranception] = None,
):
    """(msa_log_prior, eve_log_prior or None, alpha, beta) for an assay.

    ``msa_sequences`` are focus-column rows (focus first) spanning
    [rcfg.msa_start, rcfg.msa_end) of the target. The alignment is
    filtered once, and its filtered depth sets both alpha and beta. With
    ``rcfg.recalibrate`` the priors are matched to ``model``'s mean WT
    log-prob."""
    full_len = len(target_seq)
    keep = retrieval.hamming_filter(msa_sequences)
    msa_sequences = [msa_sequences[i] for i in keep]
    if msa_weights is not None:
        msa_weights = np.asarray(msa_weights)[keep]
    msa_lp = retrieval.log_msa_prior(msa_sequences, msa_weights, rcfg.msa_start,
                                     rcfg.msa_end, full_len, filter_msa=False)
    depth = len(msa_sequences)
    alpha = retrieval.msa_alpha(depth, rcfg.indel_mode, rcfg.retrieval_type)
    eve_lp, beta = None, 0.0
    if rcfg.retrieval_type == "TranceptEVE" and eve_models:
        eve_lp = retrieval.eve_log_prior(eve_models, eve_focus_seq, eve_focus_cols,
                                         rcfg.msa_start, full_len, num_samples=eve_num_samples)
        beta = retrieval.eve_beta(depth, rcfg.indel_mode, rcfg.retrieval_type)
    if rcfg.recalibrate and model is not None:
        region = slice(rcfg.msa_start, rcfg.msa_end)
        target = transformer_wt_mean_logprob(model, target_seq, rcfg.msa_start, rcfg.msa_end)
        msa_lp = msa_lp.copy()
        msa_lp[region, 5:] = retrieval.recalibrate_log_prior(msa_lp[region, 5:], target)
        if eve_lp is not None:
            cols = rcfg.msa_start + np.asarray(eve_focus_cols)
            eve_lp = eve_lp.copy()
            eve_lp[cols, 5:] = retrieval.recalibrate_log_prior(eve_lp[cols, 5:], target)
    return msa_lp, eve_lp, alpha, beta


def score_trancepteve(
    model: Tranception,
    mutants: Sequence[str],
    mutated_sequences: Sequence[str],
    target_seq: str,
    rcfg: Optional[RetrievalConfig] = None,
    msa_log_prior: Optional[np.ndarray] = None,
    eve_log_prior: Optional[np.ndarray] = None,
    alpha: float = 0.0,
    beta: float = 0.0,
    scoring_mirror: bool = True,
    batch_size: int = 32,
    indel_mode: bool = False,
) -> Table:
    """Score an assay with Tranception, fused with the priors when
    ``msa_log_prior`` and ``rcfg`` are given: the ``score_mutants_ar``
    table, on the model's device. With ``indel_mode`` every sequence is
    scored whole, against priors realigned to it (``make_indel_fusion``)."""
    device = next(model.parameters()).device
    fusion, table_of = None, None
    if msa_log_prior is not None and rcfg is not None:
        if indel_mode:
            fusion, table_of = retrieval.make_indel_fusion(
                msa_log_prior, rcfg.msa_start, rcfg.msa_end, alpha, target_seq,
                mutated_sequences, eve_prior=eve_log_prior, beta=beta, device=device)
        else:
            fusion = retrieval.make_fusion(msa_log_prior, rcfg.msa_start, rcfg.msa_end, alpha,
                                           eve_prior=eve_log_prior, beta=beta, device=device)
    return score_mutants_ar(
        model, VOCAB.tokenize, VOCAB.PAD, mutants, mutated_sequences, target_seq,
        model_context_len=model.config.n_ctx - 2, scoring_mirror=scoring_mirror,
        batch_size=batch_size, fusion=fusion, device=device, indel_mode=indel_mode,
        fusion_table_of=table_of,
    )
