"""Autoregressive (causal-LM) fitness scoring harness (counterpart of
proteingym_tpu/models/ar_scoring.py), without pandas.

The reference's recipe (ref tranception/utils/scoring_utils.py:77-203,
model_pytorch.py:878-928):

  score(x) = sum_t log p(x_t | x_<t)            [teacher forcing]

with mirroring, (score_L2R(x) + score_R2L(reverse(x))) / 2, per-window
slicing of long sequences (optimal or sliding), and the delta against the
wild type scored in the SAME window (indel assays: whole sequences against
the whole WT). Rows are padded into length buckets
of 32 tokens (which fixes the attention's T) and scored in forwards of
``batch_size`` rows; the last forward of a bucket takes what is left.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from proteingym_tpu_torch.data.table import Table
from proteingym_tpu_torch.data.windows import get_optimal_window, mutation_barycenter
from proteingym_tpu_torch.pipeline.profiler import GATHER, PLAN, READBACK, ROWS, UPLOAD, span


@dataclasses.dataclass
class SlicePlan:
    """One scoring row: a (possibly sliced) sequence plus its window."""

    mutated_sequence: str
    sliced_sequence: str
    window_start: int
    window_end: int


def get_sequence_slices(
    mutants: Sequence[str],
    mutated_sequences: Sequence[str],
    target_seq: str,
    model_context_len: int,
    start_idx: int = 1,
    scoring_window: str = "optimal",
    indel_mode: bool = False,
) -> List[SlicePlan]:
    """The slice plan with a WT row for every mutant window, deduplicated
    in first-seen order (ref scoring_utils.py:152-203): optimal windows
    centred on each mutant's mutation barycenter, or non-overlapping
    sliding windows. With ``indel_mode`` (optimal) each sequence is one
    whole row and the WT row spans the whole target."""
    plans: List[SlicePlan] = []
    seen = set()

    def add(mut_seq, sliced, ws, we):
        key = (mut_seq, sliced, ws, we)
        if key not in seen:
            seen.add(key)
            plans.append(SlicePlan(mut_seq, sliced, ws, we))

    if scoring_window == "optimal":
        for mut, seq in zip(mutants, mutated_sequences):
            if indel_mode:
                ws, we = 0, len(seq)
            else:
                positions = [int(tok[1:-1]) - start_idx for tok in mut.split(":")]
                bary = mutation_barycenter(np.asarray(positions))
                ws, we = get_optimal_window(bary, len(target_seq), model_context_len)
            add(seq, seq[ws:we], ws, we)
            wt_we = len(target_seq) if indel_mode else we
            add(target_seq, target_seq[ws:wt_we], ws, wt_we)
    elif scoring_window == "sliding":
        num_windows = 1 + int(len(target_seq) / model_context_len)
        start = 0
        for _ in range(num_windows):
            for seq in mutated_sequences:
                add(seq, seq[start:start + model_context_len], start,
                    min(len(seq), start + model_context_len))
            add(target_seq, target_seq[start:start + model_context_len], start,
                min(len(target_seq), start + model_context_len))
            start += model_context_len
    else:
        raise ValueError(f"Unknown scoring_window: {scoring_window}")
    return plans


def _length_buckets(lengths: np.ndarray, granularity: int = 32) -> np.ndarray:
    """Padded lengths: each row's length rounded up to ``granularity``."""
    return ((lengths + granularity - 1) // granularity) * granularity


def _block_loglik(logits_fn, tokens, starts, ends, fusion, pad_id, reverse, tables):
    """Summed teacher-forced log-likelihood of each row of one forward."""
    logps = torch.log_softmax(logits_fn(tokens).float(), dim=-1)
    targets = tokens[:, 1:]
    shift = logps[:, :-1]
    if fusion is not None:
        args = (shift, targets, starts, ends, reverse)
        shift = fusion(*args) if tables is None else fusion(*args, tables)
    token_ll = shift.gather(-1, targets[..., None])[..., 0]
    return (token_ll * (targets != pad_id).float()).sum(dim=1)


@torch.no_grad()
def batched_ar_loglik(
    logits_fn: Callable,
    token_rows: List[np.ndarray],
    pad_id: int,
    batch_size: int = 64,
    bucket_granularity: int = 32,
    fusion: Optional[Callable] = None,
    window_starts: Optional[np.ndarray] = None,
    window_ends: Optional[np.ndarray] = None,
    reverse: bool = False,
    device="cuda",
    fusion_row_tables: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Teacher-forced log-likelihood of each token row, float64 (N,):
    sum_t log p(x_t | x_<t) over t >= 1 (the first token is context).

    ``logits_fn`` maps (B, T) int64 tokens on ``device`` to (B, T, V)
    logits. Rows are grouped by bucketed length, in row order within a
    bucket, and scored ``batch_size`` at a time; the results are read
    back once, after the last forward is queued. ``fusion`` (a
    ``retrieval.Fusion``) rewrites the shifted log-probs with retrieval
    priors inside each row's window [``window_starts``, ``window_ends``);
    a per-row fusion (indels) reads row i's prior from its table
    ``fusion_row_tables[i]``."""
    per_row = bool(getattr(fusion, "per_row", False))
    if per_row and fusion_row_tables is None:
        raise ValueError("per-row fusion requires fusion_row_tables")
    n = len(token_rows)
    with span(PLAN):
        lengths = np.asarray([len(r) for r in token_rows])
        buckets = _length_buckets(lengths, bucket_granularity)
        if window_starts is None:
            window_starts = np.zeros(n, dtype=np.int64)
        if window_ends is None:
            window_ends = lengths
        starts_d = torch.as_tensor(np.asarray(window_starts, np.int64), device=device)
        ends_d = torch.as_tensor(np.asarray(window_ends, np.int64), device=device)
        tables_d = (torch.as_tensor(np.asarray(fusion_row_tables, np.int64), device=device)
                    if per_row else None)

        per_bucket: Dict[int, List[int]] = {}
        for ridx in np.argsort(buckets, kind="stable"):
            per_bucket.setdefault(int(buckets[ridx]), []).append(int(ridx))
    pending = []
    for bucket, idxs in per_bucket.items():
        for b0 in range(0, len(idxs), batch_size):
            block = idxs[b0:b0 + batch_size]
            with span(ROWS):
                rows = np.full((len(block), bucket), pad_id, np.int64)
                for k, ridx in enumerate(block):
                    rows[k, :lengths[ridx]] = token_rows[ridx]
                with span(UPLOAD):  # waits for the forward before
                    tokens = torch.from_numpy(rows).to(device)
                    sel = torch.as_tensor(block, device=device)
                starts, ends = starts_d[sel], ends_d[sel]
                row_tables = None if tables_d is None else tables_d[sel]
            pending.append((block, _block_loglik(
                logits_fn, tokens, starts, ends, fusion, pad_id, reverse, row_tables)))
    out = np.zeros(n, dtype=np.float64)
    for block, lls in pending:
        with span(READBACK):
            out[block] = lls.cpu().numpy()
    return out


def _group_sum_sorted(seqs: List[str], values: np.ndarray):
    """``frame.groupby(seq).sum()``: the distinct keys sorted, each group's
    sum compensated as pandas' group_sum (Kahan, in row order)."""
    keys = sorted(set(seqs))
    index = {k: i for i, k in enumerate(keys)}
    sums = np.zeros(len(keys))
    comp = np.zeros(len(keys))
    for s, v in zip(seqs, values.tolist()):
        g = index[s]
        y = v - comp[g]
        t = sums[g] + y
        comp[g] = (t - sums[g]) - y
        sums[g] = t
    return keys, sums


def _left_join(left_keys, right_keys):
    """Row pairs of a left join on one key, in pandas' order: each left row
    in order with each matching right row in order, or with None."""
    where: Dict[object, List[int]] = {}
    for j, k in enumerate(right_keys):
        where.setdefault(k, []).append(j)
    return [(i, j) for i, k in enumerate(left_keys) for j in where.get(k, [None])]


def score_mutants_ar(
    logits_fn: Callable,
    tokenize: Callable[[str], np.ndarray],
    pad_id: int,
    mutants: Sequence[str],
    mutated_sequences: Sequence[str],
    target_seq: Optional[str],
    model_context_len: int,
    scoring_window: str = "optimal",
    scoring_mirror: bool = True,
    reverse_logits_fn: Optional[Callable] = None,
    batch_size: int = 64,
    fusion: Optional[Callable] = None,
    device="cuda",
    indel_mode: bool = False,
    fusion_table_of: Optional[Dict[str, int]] = None,
) -> Table:
    """The AR pipeline with mirroring and per-window WT deltas (ref
    model_pytorch.py:878-928): the L->R pass, the R->L pass on reversed
    strings (``reverse_logits_fn`` or the same model), window sums per
    sequence (sliding), division by the full sequence length, the delta
    against the WT of the same window (optimal) or the WT total (sliding),
    averaged over the directions. With ``indel_mode`` each sequence is
    scored whole against the one WT row; ``fusion_table_of`` maps each
    mutated sequence to its realigned prior table of a per-row fusion.

    Returns the JAX frame as a ``Table``: ``mutated_sequence,
    avg_score_L_to_R[, avg_score_R_to_L], avg_score`` with its rows in the
    order of the JAX package's pandas merges, plus a WT row of zeros when
    the WT is one of ``mutated_sequences``."""
    with span(PLAN):
        plans = get_sequence_slices(
            mutants, mutated_sequences,
            target_seq if target_seq is not None else mutated_sequences[0],
            model_context_len,
            scoring_window=scoring_window if target_seq is not None else "sliding",
            indel_mode=indel_mode,
        )
        tables = (None if fusion_table_of is None else
                  np.asarray([fusion_table_of[p.mutated_sequence] for p in plans], np.int64))
    summed = scoring_window == "sliding" or target_seq is None

    def one_direction(reverse: bool):
        fn = (reverse_logits_fn or logits_fn) if reverse else logits_fn
        with span(PLAN):
            rows = [tokenize(p.sliced_sequence[::-1] if reverse else p.sliced_sequence)
                    for p in plans]
            window_starts = np.asarray([p.window_start for p in plans])
            window_ends = np.asarray([p.window_end for p in plans])
        lls = batched_ar_loglik(
            fn, rows, pad_id, batch_size=batch_size, fusion=fusion,
            window_starts=window_starts, window_ends=window_ends,
            reverse=reverse, device=device, fusion_row_tables=tables,
        )
        with span(GATHER):
            seqs = [p.mutated_sequence for p in plans]
            starts = [p.window_start for p in plans]
            if summed:
                seqs, lls = _group_sum_sorted(seqs, lls)
                starts = [None] * len(seqs)
            return to_delta(seqs, starts,
                            lls / np.asarray([len(s) for s in seqs], dtype=np.float64))

    def to_delta(seqs, starts, scores):
        """(mutated sequences, deltas) of the non-WT rows."""
        if target_seq is None:
            return seqs, scores
        mut = [i for i, s in enumerate(seqs) if s != target_seq]
        wt = [i for i, s in enumerate(seqs) if s == target_seq]
        if scoring_window == "optimal":
            pairs = _left_join([starts[i] for i in mut], [starts[i] for i in wt])
            return ([seqs[mut[i]] for i, _ in pairs],
                    np.asarray([scores[mut[i]] - (np.nan if j is None else scores[wt[j]])
                                for i, j in pairs], dtype=np.float64))
        return [seqs[i] for i in mut], scores[mut] - float(scores[wt[0]])

    l2r_seqs, l2r = one_direction(False)
    if scoring_mirror:
        r2l_seqs, r2l = one_direction(True)
    with span(GATHER):
        table = Table()
        if scoring_mirror:
            pairs = _left_join(l2r_seqs, r2l_seqs)
            left = np.asarray([l2r[i] for i, _ in pairs], dtype=np.float64)
            right = np.asarray([np.nan if j is None else r2l[j] for _, j in pairs],
                               dtype=np.float64)
            table["mutated_sequence"] = [l2r_seqs[i] for i, _ in pairs]
            table["avg_score_L_to_R"] = left
            table["avg_score_R_to_L"] = right
            table["avg_score"] = (left + right) / 2.0
        else:
            table["mutated_sequence"] = l2r_seqs
            table["avg_score_L_to_R"] = l2r
            table["avg_score"] = l2r.copy()
        # the WT scores 0 by definition when it is in the assay (ref :919-927)
        if target_seq is not None and target_seq in set(mutated_sequences):
            grown = Table()
            for name, col in table.columns.items():
                tail = [target_seq] if name == "mutated_sequence" else [0.0]
                grown[name] = np.concatenate([col, np.asarray(tail, dtype=col.dtype)])
            table = grown
    return table
