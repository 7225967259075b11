"""The scoring protocols, worked out again by the benchmark for its plain
reference: which rows a mutant's score needs and how the score is summed.
Nothing here imports the port; the window rule is a frozen copy of the
reference ProteinGym one (``get_optimal_window``), so that the
comparison does not take the program's own rows on trust.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch


def optimal_window(position: int, length: int, window: int) -> Tuple[int, int]:
    """[start, end) of the ``window``-token slice that scores ``position`` of
    a ``length``-token vector (ProteinGym's ``get_optimal_window``, with
    its quirk that an interior window is ``2 * (window // 2)`` wide)."""
    half = window // 2
    if length <= window:
        return 0, length
    if position < half:
        return 0, window
    if position >= length - half:
        return length - window, length
    return max(0, position - half), min(length, position + half)


def parse_mutant(mutant: str) -> List[Tuple[str, int, str]]:
    """``"A12C:D45E"`` -> [("A", 12, "C"), ("D", 45, "E")], positions 1-based."""
    return [(tok[0], int(tok[1:-1]), tok[-1]) for tok in mutant.split(":")]


def apply_mutant(seq: str, mutant: str) -> str:
    out = list(seq)
    for wt, pos, mt in parse_mutant(mutant):
        if out[pos - 1] != wt:
            raise ValueError(f"{mutant}: the wild type at {pos} is {out[pos - 1]}")
        out[pos - 1] = mt
    return "".join(out)


def masked_logprobs(logits_fn: Callable[[torch.Tensor], torch.Tensor], tokens: np.ndarray,
                    positions: Sequence[int], mask_idx: int, window: int, device,
                    block: int = 16) -> Dict[int, np.ndarray]:
    """{token position: (V,) float32 log-probs at that position from a
    forward with it masked}: the whole token vector where it fits the
    window, else the position's optimal window. Rows of one length run
    ``block`` at a time."""
    tokens = np.asarray(tokens, dtype=np.int64)
    rows: Dict[int, List[Tuple[int, np.ndarray, int]]] = {}
    for p in sorted(set(int(p) for p in positions)):
        start, end = optimal_window(p, len(tokens), window)
        row = tokens[start:end].copy()
        row[p - start] = mask_idx
        rows.setdefault(len(row), []).append((p, row, p - start))
    out: Dict[int, np.ndarray] = {}
    for items in rows.values():
        for b0 in range(0, len(items), block):
            part = items[b0:b0 + block]
            batch = torch.as_tensor(np.stack([r for _, r, _ in part]), device=device)
            logits = logits_fn(batch)
            at = torch.as_tensor([o for _, _, o in part], device=device)
            picked = logits[torch.arange(len(part), device=device), at].float()
            logp = torch.log_softmax(picked, dim=-1).cpu().numpy()
            for (p, _, _), lp in zip(part, logp):
                out[p] = lp
    return out


def masked_marginal_score(mutant: str, logprobs: Dict[int, np.ndarray],
                          index: Dict[str, int], bos: int = 1) -> float:
    """Sum over the mutant's sites of log p(mt) - log p(wt), each site read
    at its own masked token position (sequence position + ``bos``)."""
    total = 0.0
    for wt, pos, mt in parse_mutant(mutant):
        lp = logprobs[pos - 1 + bos]
        total += float(lp[index[mt]]) - float(lp[index[wt]])
    return total


def sliding_windows(length: int, n_ctx: int) -> List[Tuple[int, int]]:
    """The non-overlapping [start, end) windows of an AR row."""
    return [(s, min(length, s + n_ctx)) for s in range(0, max(length, 1), n_ctx)]


def ar_mirrored_scores(loglik_fn: Callable[[List[np.ndarray]], np.ndarray],
                       tokenize: Callable[[str], np.ndarray], seqs: Sequence[str],
                       n_ctx: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per sequence, the teacher-forced log-likelihood summed over its
    sliding windows and divided by its length, left to right and on the
    reversed string: (L->R, R->L), float64. ``loglik_fn`` takes token rows
    and returns each row's sum of log p(x_t | x_<t) over t >= 1."""
    def direction(reverse: bool) -> np.ndarray:
        rows, owner = [], []
        for i, s in enumerate(seqs):
            s = s[::-1] if reverse else s
            for a, b in sliding_windows(len(s), n_ctx):
                rows.append(tokenize(s[a:b]))
                owner.append(i)
        sums = np.zeros(len(seqs))
        np.add.at(sums, owner, np.asarray(loglik_fn(rows), dtype=np.float64))
        return sums / np.asarray([len(s) for s in seqs], dtype=np.float64)
    return direction(False), direction(True)
