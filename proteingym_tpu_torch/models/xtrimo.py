"""xTrimoPGLM-class scoring in both its MLM and AR modes (counterpart of
proteingym_tpu/models/xtrimo.py; ref proteingym/baselines/xtrimopglm/
compute_fitness.py):

- the trunk is ESM-C's (``models/esmc.py``), bidirectional over the
  non-pad keys in ``mlm`` mode and causal in ``ar`` mode; the AR head is
  the head's last matrix alone in float32, without the RegressionHead's
  first layers or a head bias, as the JAX ``apply(mode="ar")`` has it;
- the reference's scoring recipes, copied verbatim: one masked row per
  unique mutated position in its centred window (MLM), and the chunked
  teacher-forced CLM delta log-likelihood (AR); an invalid mutant is
  dropped by the recipe and scores NaN.

The JAX function runs each masked row, or each chunk of each sequence,
as its own forward at batch 1. Here the rows are independent inputs of
one length, so ``score_assay`` first computes every row the recipe will
ask for in forwards of ``batch_size`` rows (rows of equal length
together), then runs the recipe over those results: the same function
with fewer forwards.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from proteingym_tpu_torch.models.esmc import ALPHABET, EsmcConfig, EsmcModel


@dataclasses.dataclass(frozen=True)
class XtrimoConfig(EsmcConfig):
    name: str = "xtrimopglm_1b"


PRESETS = {
    "xtrimopglm_tiny": XtrimoConfig("xtrimopglm_tiny", 2, 64, 4),
    "xtrimopglm_1b": XtrimoConfig("xtrimopglm_1b", 24, 2048, 16),
    "xtrimopglm_3b": XtrimoConfig("xtrimopglm_3b", 30, 2560, 20),
}


def apply(model: EsmcModel, tokens: torch.Tensor, mode: str = "mlm") -> torch.Tensor:
    """(B, T) tokens -> (B, T, V) float32 logits: the ESM-C forward in
    ``mlm`` mode; in ``ar`` mode the causal trunk and the head's last
    matrix alone (``lm_head``, or the RegressionHead's output layer without
    its bias), as the JAX function reads ``params["head"]``."""
    if mode == "mlm":
        return model(tokens)
    head = model.sequence_head[3] if hasattr(model, "sequence_head") else model.lm_head
    return model.trunk(tokens, causal=True) @ head.weight.t()


# ---------------------------------------------------------------------------
# The reference's scoring recipes, verbatim
# ---------------------------------------------------------------------------

AA_VOCAB = "ACDEFGHIKLMNPQRSTVWY"
_MUT_RE = re.compile(r"([A-Z])(\d+)([A-Z])")


def mlm_window_for_position(seq_len: int, seq_pos: int,
                            window_size: int = 1024):
    """(start, end, rel_pos) of the masked-marginal context window for a
    0-based position, the reference's logic (ref compute_fitness.py:169-181)
    including its quirk: when the window reaches the sequence end, start
    snaps left but ``end`` keeps the pre-snap value, so the final windows
    all end at seq_len."""
    if seq_len > window_size - 2:  # account for special tokens
        half = (window_size - 2) // 2
        start = max(0, seq_pos - half)
        end = min(seq_len, start + window_size - 2)
        if end == seq_len:
            start = max(0, seq_len - (window_size - 2))
        return start, end, seq_pos - start
    return 0, seq_len, seq_pos


def parse_mutations(sequence: str, mutations: Sequence[str]):
    """The reference's parsing and validation (ref :45-126): sub-mutants
    split on ':', regex-validated, positions bounds- and wt-checked; an
    invalid mutation is dropped from the result, not an error. Returns
    (parsed, unique_positions), parsed rows (pos_list_1based, mt_string,
    name)."""
    parsed, unique_positions = [], set()
    for mutation in mutations:
        rows, ok = [], True
        for sub in str(mutation).split(":"):
            m = _MUT_RE.fullmatch(sub)
            if not m:
                ok = False
                break
            wt, pos_str, mt = m.groups()
            pos = int(pos_str)
            if not (0 <= pos - 1 < len(sequence)) or sequence[pos - 1] != wt:
                ok = False
                break
            rows.append((pos, mt))
        if ok and rows:
            parsed.append(([p for p, _ in rows],
                           "".join(mt for _, mt in rows), mutation))
            unique_positions.update(p for p, _ in rows)
    return parsed, sorted(unique_positions)


def score_mutations_mlm_recipe(
    sequence: str,
    mutations: Sequence[str],
    mask_logprobs_fn,
    window_size: int = 1024,
):
    """The reference's MLM protocol (ref score_mutations_mlm,
    compute_fitness.py:15-266): a masked log-prob row for every unique
    mutated position (its centred window for long sequences), then each
    mutation's sum of logp[mt] - logp[wt] over its sub-mutants.
    ``mask_logprobs_fn(window_str, rel_pos)`` returns log-probs over
    AA_VOCAB at the masked position. Returns {mutation: score}, invalid
    mutations dropped."""
    parsed, positions = parse_mutations(sequence, mutations)
    aa_index = {a: i for i, a in enumerate(AA_VOCAB)}
    pos_scores = {}
    for pos in positions:
        start, end, rel = mlm_window_for_position(
            len(sequence), pos - 1, window_size)
        logps = np.asarray(mask_logprobs_fn(sequence[start:end], rel))
        pos_scores[pos] = logps
    out = {}
    for pos_list, mts, name in parsed:
        total = 0.0
        for pos, mt in zip(pos_list, mts):
            row = pos_scores[pos]
            total += float(row[aa_index[mt]] - row[aa_index[sequence[pos - 1]]])
        out[name] = total
    return out


def clm_chunks(sequence: str, window_size: int = 1024) -> List[str]:
    """The reference's CLM chunks (ref calc_sequence_clm_score_batch): a
    sequence longer than window_size - 2 residues split into
    non-overlapping chunks of that many, each tokenized on its own."""
    w = window_size - 2
    return ([sequence[i:i + w] for i in range(0, len(sequence), w)]
            if len(sequence) > w else [sequence])


def clm_sequence_score(sequence: str, chunk_nll_fn,
                       window_size: int = 1024) -> float:
    """The reference's CLM sequence score (ref
    calc_sequence_clm_score_batch, compute_fitness.py:373-419):
    -(total teacher-forced CE) / (total target tokens) over ``clm_chunks``.
    ``chunk_nll_fn(chunk_str) -> (sum_ce, n_target_tokens)``."""
    total, count = 0.0, 0
    for chunk in clm_chunks(sequence, window_size):
        s, n = chunk_nll_fn(chunk)
        total += float(s)
        count += int(n)
    return -total / count


def score_mutations_clm_recipe(
    sequence: str,
    mutations: Sequence[str],
    chunk_nll_fn,
    window_size: int = 1024,
):
    """The reference's CLM protocol (ref score_mutations_clm,
    compute_fitness.py:294-370): clm_score(mutated_seq) - clm_score(wt),
    invalid mutations dropped. Returns {mutation: score}."""
    wt_score = clm_sequence_score(sequence, chunk_nll_fn, window_size)
    parsed, _ = parse_mutations(sequence, mutations)
    out = {}
    for pos_list, mts, name in parsed:
        mutated = list(sequence)
        for pos, mt in zip(pos_list, mts):
            mutated[pos - 1] = mt
        out[name] = clm_sequence_score(
            "".join(mutated), chunk_nll_fn, window_size) - wt_score
    return out


# ---------------------------------------------------------------------------
# Scoring: the recipes over rows computed in batches
# ---------------------------------------------------------------------------

@torch.no_grad()
def _batched(rows: List[np.ndarray], batch_size: int, fn: Callable) -> List:
    """``fn(tokens (n, T), i)`` -> a list of n results, over the token rows
    in forwards of up to ``batch_size`` rows of one length; the results in
    the rows' order. ``i`` lists the indices of the forward's rows."""
    out: List = [None] * len(rows)
    by_len: Dict[int, List[int]] = {}
    for i, r in enumerate(rows):
        by_len.setdefault(len(r), []).append(i)
    for idx in by_len.values():
        for s in range(0, len(idx), batch_size):
            part = idx[s:s + batch_size]
            for i, res in zip(part, fn(np.stack([rows[i] for i in part]), part)):
                out[i] = res
    return out


def mlm_rows(sequence: str, mutants: Sequence[str], window_size: int = 1024
             ) -> List[Tuple[str, int]]:
    """The (window_str, rel_pos) rows ``score_mutations_mlm_recipe`` asks
    for, one per unique valid position."""
    _, positions = parse_mutations(sequence, mutants)
    rows = []
    for pos in positions:
        start, end, rel = mlm_window_for_position(len(sequence), pos - 1, window_size)
        rows.append((sequence[start:end], rel))
    return rows


def clm_rows(sequence: str, mutants: Sequence[str], window_size: int = 1024) -> List[str]:
    """The unique chunk strings ``score_mutations_clm_recipe`` asks for:
    the WT's and every valid mutant's."""
    parsed, _ = parse_mutations(sequence, mutants)
    seqs = [sequence]
    for pos_list, mts, _ in parsed:
        mutated = list(sequence)
        for pos, mt in zip(pos_list, mts):
            mutated[pos - 1] = mt
        seqs.append("".join(mutated))
    return list(dict.fromkeys(c for s in seqs for c in clm_chunks(s, window_size)))


def score_assay(
    model: EsmcModel,
    sequence: str,
    mutants: Sequence[str],
    mode: str = "mlm",
    batch_size: int = 16,
    window_size: int = 1024,
) -> np.ndarray:
    """MLM: the reference's unique-position masked marginals over the
    bidirectional trunk, each row's float32 log-softmax over all logits
    restricted to AA_VOCAB; AR: its chunked CLM delta log-likelihood over
    the causal trunk. Rows go through the model ``batch_size`` at a time
    (``batch_size=1`` is the JAX function's row at a time). An invalid
    mutant scores NaN."""
    device = next(model.parameters()).device
    if mode == "mlm":
        aa_cols = torch.as_tensor([ALPHABET.get_idx(a) for a in AA_VOCAB], device=device)
        rows = mlm_rows(sequence, mutants, window_size)
        tokens = []
        for window_str, rel in rows:
            toks = ALPHABET.tokenize(window_str)
            toks[1 + rel] = ALPHABET.mask_idx  # CLS offset
            tokens.append(toks)

        def forward(batch, part):
            toks = torch.as_tensor(batch, dtype=torch.long, device=device)
            at = torch.as_tensor([1 + rows[i][1] for i in part], device=device)
            logits = apply(model, toks, "mlm")[torch.arange(len(part), device=device), at]
            return torch.log_softmax(logits.float(), dim=-1)[:, aa_cols].cpu().numpy()

        table = dict(zip(rows, _batched(tokens, batch_size, forward)))
        scores = score_mutations_mlm_recipe(
            sequence, mutants, lambda w, rel: table[(w, rel)], window_size)
    else:
        chunks = clm_rows(sequence, mutants, window_size)
        tokens = [ALPHABET.tokenize(c) for c in chunks]

        def forward(batch, part):
            toks = torch.as_tensor(batch, dtype=torch.long, device=device)
            inp, tgt = toks[:, :-1], toks[:, 1:]
            logps = torch.log_softmax(apply(model, inp, "ar").float(), dim=-1)
            nll = -logps.gather(-1, tgt[..., None])[..., 0].sum(-1)
            return [(s, tgt.shape[1]) for s in nll.cpu().numpy()]

        table = dict(zip(chunks, _batched(tokens, batch_size, forward)))
        scores = score_mutations_clm_recipe(sequence, mutants, table.__getitem__, window_size)
    return np.asarray([scores.get(m, np.nan) for m in mutants])
