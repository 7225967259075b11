"""GEMME: global epistatic model over evolutionary (tree) distances
(counterpart of proteingym_tpu/models/gemme.py, whose banner maps each
step to Laine, Karami & Carbone 2019 and marks the reconstructions).

- Trace levels T(i): Mihalek-style ranked evolutionary traces over
  neighbour-joining trees of weighted row samples (the port's
  ``native.nj_tree``), averaged over ``n_trace_trees`` trees.
- Epistatic term: -T(i) * Dmin(a, i) / Dmax, Dmin the smallest distance
  from the query to a row carrying a at i; patristic distances on the
  tree for the sampled rows, an affine p-distance calibration for the
  rest; unseen letters at 1.5 Dmax.
- Independent term: T(i) * log f_i(a), pseudocounted weighted
  frequencies.
- Both tables rescaled to [0, 1] and combined with alpha = 0.4 + 0.2
  exp(-Neff / 30), clipped to [0.4, 0.6].

On ``device``, in float64: the column counts (one weighted ``bincount``),
the p-distance of every row to the query, and the smallest carrier
distance of each (column, letter) (one ``scatter_reduce``). They equal the
JAX package's numbers up to the order of the weighted sums. On the host,
as there: the row samples (``np.random.default_rng(seed)``, so the same
weights give the same samples and trees), the trees, the traces, the
patristic distances and the ``lstsq`` calibration. With ``use_tree=False``
or fewer than 4 rows the model is the JAX package's surrogate
(identity distances and entropy conservation, ``method="surrogate"``),
which is part of the algorithm; a tree that cannot be built raises.

ESCOTT rides on this model (pipeline/scorers.py): ``escott_extract_scores``
and ``escott_parse_alignment`` are the reference's own recipe
(ref escott/compute_fitness.py:75-101).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from proteingym_tpu_torch import native
from proteingym_tpu_torch.data.mutants import is_wt_row
from proteingym_tpu_torch.devices import resolve_device
from proteingym_tpu_torch.msa.columns import column_counts

AA20 = "ACDEFGHIKLMNPQRSTVWY"


@dataclasses.dataclass
class GemmeModel:
    pred_epi: np.ndarray  # (L, 20) epistatic effect (higher = fitter)
    pred_ind: np.ndarray  # (L, 20) independent effect
    conservation: np.ndarray  # (L,) trace levels T(i)
    wt_codes: np.ndarray  # (L,)
    alphabet: str = AA20
    alpha: float = 0.5  # independent-model weight in the combination
    method: str = "tree"  # "tree" or "surrogate"

    def combined(self) -> np.ndarray:
        return (1.0 - self.alpha) * self.pred_epi + self.alpha * self.pred_ind


# ---------------------------------------------------------------------------
# Tree machinery (host)
# ---------------------------------------------------------------------------


def _patristic_from_leaf(tree, n: int, leaf: int) -> np.ndarray:
    """Distances from one leaf to every leaf along the NJ merge tree
    (branch lengths clamped at 0: NJ can emit slightly negative ones)."""
    left, right, llen, rlen = tree
    tot = 2 * n - 1
    adj: list = [[] for _ in range(tot)]
    for k in range(n - 1):
        p = n + k
        for child, w in ((int(left[k]), max(float(llen[k]), 0.0)),
                         (int(right[k]), max(float(rlen[k]), 0.0))):
            adj[p].append((child, w))
            adj[child].append((p, w))
    dist = np.full(tot, -1.0)
    dist[leaf] = 0.0
    stack = [leaf]
    while stack:
        u = stack.pop()
        for v, w in adj[u]:
            if dist[v] < 0:
                dist[v] = dist[u] + w
                stack.append(v)
    return dist[:n]


def _ranked_et_trace(sub: np.ndarray, tree) -> np.ndarray:
    """Mihalek-style ranked evolutionary trace on one NJ tree: rank(i) =
    2 + the depth-order index of the deepest node polymorphic at column i
    (1 when the column is monomorphic); T(i) = 1 - (rank - 1) / n_internal."""
    left, right, llen, rlen = tree
    n, L = sub.shape
    m = n - 1
    sym = np.empty((2 * n - 1, L), np.int16)
    sym[:n] = sub
    mono = np.ones((2 * n - 1, L), bool)
    for k in range(m):  # children always precede their parent
        a, b, p = int(left[k]), int(right[k]), n + k
        same = mono[a] & mono[b] & (sym[a] == sym[b])
        mono[p] = same
        sym[p] = np.where(same, sym[a], -1)
    depth = np.zeros(2 * n - 1)
    for k in range(m - 1, -1, -1):  # top-down from the root (last merge)
        p = n + k
        depth[int(left[k])] = depth[p] + max(float(llen[k]), 1e-9)
        depth[int(right[k])] = depth[p] + max(float(rlen[k]), 1e-9)
    order = np.argsort(depth[n:], kind="stable")  # ascending root distance
    rank_of = np.empty(m, np.int64)
    rank_of[order] = np.arange(m)
    poly = ~mono[n:]  # (m, L): node needs splitting at this column
    deepest = np.where(poly, rank_of[:, None], -1).max(0)  # (L,)
    rank = np.where(deepest < 0, 1, deepest + 2).astype(np.float64)
    return 1.0 - (rank - 1.0) / m


def _sample_rows(n: int, weights: np.ndarray, size: int, focus_row: int,
                 rng: np.random.Generator) -> np.ndarray:
    if size >= n:
        return np.arange(n)
    p = np.asarray(weights, np.float64)
    p = p / p.sum()
    idx = rng.choice(n, size=size, replace=False, p=p)
    if focus_row not in idx:
        idx[0] = focus_row
    return np.unique(idx)


# ---------------------------------------------------------------------------
# Device statistics (float64)
# ---------------------------------------------------------------------------


def _p_distance_to_query(m: torch.Tensor, focus_row: int) -> torch.Tensor:
    """(N,) fractional mismatch to the query over non-gap positions, over
    min(nongap_row, nongap_query) (the NJ builder's convention)."""
    query = m[focus_row]
    nongap = (m > 0).sum(1)
    q_nongap = int((query > 0).sum())
    matches = ((m == query[None]) & (m > 0)).sum(1)
    den = torch.clamp(nongap, max=q_nongap)
    return torch.where(den > 0, 1.0 - matches.double() / den.clamp(min=1).double(),
                       torch.ones((), dtype=torch.float64, device=m.device))


def _min_carrier_distance(m: torch.Tensor, dist: torch.Tensor, q: int) -> torch.Tensor:
    """(L, q) smallest distance to the query among the rows carrying each
    letter at each column (inf where none does)."""
    n, length = m.shape
    aa = m.long() - 1
    live = (aa >= 0) & (aa < q)
    cells = (torch.arange(length, device=m.device) * q + aa)[live]
    dmin = torch.full((length * q,), float("inf"), dtype=torch.float64, device=m.device)
    dmin.scatter_reduce_(0, cells, dist[:, None].expand(n, length)[live], reduce="amin")
    return dmin.view(length, q)


def _entropy_conservation(freq: np.ndarray, q: int) -> np.ndarray:
    f = np.maximum(freq, 1e-12)
    ent = -(f * np.log(f)).sum(1)
    return 1.0 - ent / np.log(q)


def _normalize(x: np.ndarray) -> np.ndarray:
    lo, hi = x.min(), x.max()
    return (x - lo) / (hi - lo + 1e-12)


# ---------------------------------------------------------------------------
# Fitting
# ---------------------------------------------------------------------------


def fit_gemme(
    matrix: np.ndarray,
    weights: Optional[np.ndarray] = None,
    focus_row: int = 0,
    q: int = 20,
    tree_size: int = 512,
    n_trace_trees: int = 3,
    seed: int = 0,
    use_tree: Optional[bool] = None,
    device="cuda",
) -> GemmeModel:
    """matrix: (N, L) int codes (0 gap, 1..20 amino acids), the query at
    ``focus_row``. ``tree_size`` bounds each NJ problem (a weighted sample,
    the query always in it); ``n_trace_trees`` trees are averaged for the
    trace levels; ``use_tree=False`` selects the surrogate."""
    dev = resolve_device(device)
    matrix = np.asarray(matrix)
    n, L = matrix.shape
    if weights is None:
        weights = np.ones(n)
    query = matrix[focus_row]
    neff = float(np.asarray(weights).sum())
    m = torch.as_tensor(matrix, device=dev)

    counts = column_counts(matrix, weights, q=q, device=dev)
    freq = (counts + 0.05) / (counts.sum(1, keepdims=True) + 0.05 * q)
    pdist = _p_distance_to_query(m, focus_row)

    if use_tree is False or n < 4:
        dist = pdist
        cons = _entropy_conservation(freq, q)
        method = "surrogate"
    else:
        rng = np.random.default_rng(seed)
        sample_idx = _sample_rows(n, weights, tree_size, focus_row, rng)
        sub = matrix[sample_idx]
        tree = native.nj_tree(sub.astype(np.int8))
        qpos = int(np.nonzero(sample_idx == focus_row)[0][0])
        ns = len(sample_idx)
        # trace levels averaged over independently sampled trees (the first
        # doubles as the distance tree); a sample of the whole alignment
        # would rebuild the same tree, so one is enough then
        traces = [_ranked_et_trace(sub, tree)]
        if ns < n:
            for _ in range(1, n_trace_trees):
                idx_t = _sample_rows(n, weights, tree_size, focus_row, rng)
                traces.append(_ranked_et_trace(
                    matrix[idx_t], native.nj_tree(matrix[idx_t].astype(np.int8))))
        cons = np.mean(traces, axis=0)
        # patristic distances to the query for the sampled rows, an affine
        # p-distance -> patristic calibration for the rest
        pat = _patristic_from_leaf(tree, ns, qpos)
        pd_np = pdist.cpu().numpy()
        A = np.stack([pd_np[sample_idx], np.ones(ns)], 1)
        coef, *_ = np.linalg.lstsq(A, pat, rcond=None)
        slope = max(float(coef[0]), 0.0)
        dist_np = np.maximum(slope * pd_np + float(coef[1]), 0.0)
        dist_np[sample_idx] = pat
        dist = torch.as_tensor(dist_np, device=dev)
        method = "tree"

    dmin = _min_carrier_distance(m, dist, q).cpu().numpy()
    worst = float(dist.max()) if n > 1 else 1.0
    dmin[~np.isfinite(dmin)] = worst * 1.5  # unseen letter: beyond the largest distance
    dnorm = dmin / max(worst, 1e-12)

    pred_epi = -cons[:, None] * dnorm
    pred_ind = cons[:, None] * np.log(freq)
    alpha = float(np.clip(0.4 + 0.2 * np.exp(-neff / 30.0), 0.4, 0.6))
    return GemmeModel(pred_epi=_normalize(pred_epi), pred_ind=_normalize(pred_ind),
                      conservation=cons, wt_codes=query, alpha=alpha, method=method)


def score_mutants(model: GemmeModel, wt_focus_seq: str, mutants: Sequence[str],
                  mode: str = "combined", offset_idx: int = 1) -> np.ndarray:
    """Delta against the WT per mutated position, summed (higher = fitter)."""
    table = {"combined": model.combined(), "epistatic": model.pred_epi,
             "independent": model.pred_ind}[mode]
    aa_idx = {a: i for i, a in enumerate(model.alphabet)}
    out = np.zeros(len(mutants))
    for i, m in enumerate(mutants):
        if is_wt_row(m):
            continue
        for tok in m.split(":"):
            wt, pos, mt = tok[0], int(tok[1:-1]) - offset_idx, tok[-1]
            if wt_focus_seq[pos] != wt:
                raise ValueError(f"WT mismatch in {tok}")
            out[i] += table[pos, aa_idx[mt]] - table[pos, aa_idx[wt]]
    return out


# ---------------------------------------------------------------------------
# ESCOTT: the reference's ingestion recipe
# ---------------------------------------------------------------------------

ESCOTT_AA_VOCAB = "ACDEFGHIKLMNPQRSTVWY"
_ESCOTT_AA2IDX = {a: i for i, a in enumerate(ESCOTT_AA_VOCAB)}


def escott_extract_scores(predictions: np.ndarray, mutants: Sequence[str],
                          offset: int) -> list:
    """Per-mutant scores from a full (L, 20) mutational landscape (ref
    escott/compute_fitness.py:92-101, extract_scores): the raw landscape
    entries summed over sub-mutants, positions shifted by ``offset``."""
    scores = []
    for mut in mutants:
        score = 0
        for m in str(mut).split(":"):
            pos, mut_aa = int(m[1:-1]) - offset, m[-1]
            score += predictions[pos, _ESCOTT_AA2IDX[mut_aa]]
        scores.append(score)
    return scores


def escott_parse_alignment(lines: Sequence[str]) -> dict:
    """FASTA alignment sanitised as the reference feeds ESCOTT (ref
    escott/compute_fitness.py:75-88, parse_alignment): '_' and '.' dropped
    from headers, sequence lines uppercased with '.' gaps rewritten '-'."""
    seqs: dict = {}
    seq_id = None
    for line in lines:
        if line[:1] == ">":
            seq_id = line[1:].strip().replace("_", "").replace(".", "")
            seqs[seq_id] = ""
        else:
            seqs[seq_id] += line.strip().upper().replace(".", "-")
    return seqs
