"""PROVEAN: delta alignment scores against a clustered supporting set
(counterpart of proteingym_tpu/models/provean.py).

The reference's PROVEAN column comes from the external tool (Choi et al.
2012): BLAST homologs clustered at 75% identity (CD-HIT), and a variant's
score is the mean over the top clusters of the mean BLOSUM62 affine-gap
alignment delta

    delta(v, s) = align(variant, s) - align(wild_type, s)

with gap open 10 and extend 1. Negative scores are deleterious. The
alignment absorbs length changes, so indels score too. As in the JAX
package, the supporting set comes from the assay's alignment (ungapped
rows, greedily clustered by 3-mer Jaccard similarity, the clusters
ordered by similarity to the query).

On ``device``: the score-only Gotoh recursion over every (variant,
supporting sequence) pair of a length bucket at once, one step per query
residue on a (pairs, l2 + 1) float32 state. The within-row affine gap is
a prefix max (``torch.cummax``): Iy[j] = -open - (j - 1) ext + max_{k<j}
(max(M[k], Ix[k]) + k ext). Every cell holds a small integer (or the
-1e9 of an unreachable state, which never wins), so the scores equal the
JAX package's exactly. Subjects are padded to a multiple of 32 with code
0 and read at their own length, so the padding never reaches a score.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from proteingym_tpu_torch.devices import resolve_device

BLOSUM_ALPHABET = "ARNDCQEGHILKMFPSTWYVBZX*"

# canonical BLOSUM62 (NCBI), rows/cols in BLOSUM_ALPHABET order
_B62 = """
 4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0 -2 -1  0 -4
-1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3 -1  0 -1 -4
-2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3  3  0 -1 -4
-2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3  4  1 -1 -4
 0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1 -3 -3 -2 -4
-1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2  0  3 -1 -4
-1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
 0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3 -1 -2 -1 -4
-2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3  0  0 -1 -4
-1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3 -3 -3 -1 -4
-1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1 -4 -3 -1 -4
-1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2  0  1 -1 -4
-1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1 -3 -1 -1 -4
-2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1 -3 -3 -1 -4
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2 -2 -1 -2 -4
 1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2  0  0  0 -4
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0 -1 -1  0 -4
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3 -4 -3 -2 -4
-2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1 -3 -2 -1 -4
 0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4 -3 -2 -1 -4
-2 -1  3  4 -3  0  1 -1  0 -3 -4  0 -3 -3 -2  0 -1 -4 -3 -3  4  1 -1 -4
-1  0  0  1 -3  3  4 -2  0 -3 -3  1 -1 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
 0 -1 -1 -1 -2 -1 -1 -1 -1 -1 -1 -1 -1 -1 -2  0  0 -2 -1 -1 -1 -1 -1 -4
-4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4  1
"""

BLOSUM62 = np.array(
    [[int(v) for v in row.split()] for row in _B62.strip().splitlines()],
    np.float32,
)
_IDX = {a: i for i, a in enumerate(BLOSUM_ALPHABET)}


def encode(seq: str) -> np.ndarray:
    return np.asarray([_IDX.get(c, _IDX["X"]) for c in seq], np.int32)


NEG = -1e9  # an unreachable state (exact in float32)
# (pairs x (l2 + 1)) cells of one call's DP state: ~0.5 GB a float32
# state tensor, and the row step holds about eight of them
PAIR_CELLS = 1 << 27


def _gotoh_scores(Q: torch.Tensor, S: torch.Tensor, lens: torch.Tensor, gap_open: float,
                  gap_extend: float) -> torch.Tensor:
    """(B,) float32 global Gotoh scores of the (B, l1) query codes against
    the (B, l2) padded subject codes, each read at its own length."""
    dev = S.device
    B, l2 = S.shape
    sub = torch.as_tensor(BLOSUM62, device=dev)
    go = torch.tensor(gap_open, dtype=torch.float32, device=dev)
    ge = torch.tensor(gap_extend, dtype=torch.float32, device=dev)
    j = torch.arange(l2 + 1, dtype=torch.float32, device=dev)
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    # DP row 0: M only at j = 0; leading gaps go through Iy
    m = torch.where(j == 0, 0.0, neg).expand(B, l2 + 1).contiguous()
    ix = torch.full((B, l2 + 1), NEG, dtype=torch.float32, device=dev)
    iy = torch.where(j > 0, -go - (j - 1) * ge, neg).expand(B, l2 + 1).contiguous()
    j_ext = j * ge
    iy_open = -go - (j[1:] - 1) * ge
    S = S.long()
    for r in range(Q.shape[1]):
        best = torch.maximum(torch.maximum(m, ix), iy)
        subs = torch.gather(sub[Q[:, r].long()], 1, S)  # (B, l2): BLOSUM62[q_r, s_j]
        ix = torch.maximum(m - go, ix - ge)
        m = torch.empty_like(best)
        m[:, 0] = NEG
        torch.add(best[:, :-1], subs, out=m[:, 1:])
        # iy[j] = -open - (j - 1) ext + max_{k <= j-1} (max(m, ix)[k] + k ext)
        pref = torch.cummax(torch.maximum(m, ix) + j_ext, dim=1).values
        iy = torch.empty_like(best)
        iy[:, 0] = NEG
        torch.add(iy_open, pref[:, :-1], out=iy[:, 1:])
    final = torch.maximum(torch.maximum(m, ix), iy)
    return final.gather(1, lens.long()[:, None])[:, 0]


def _padded_codes(seqs: Sequence[str], pad_to: int, dev) -> tuple:
    """(n, l2) codes of ``seqs``, padded with code 0 to a multiple of
    ``pad_to``, and their (n,) lengths, on ``dev``."""
    l2 = ((max(len(s) for s in seqs) + pad_to - 1) // pad_to) * pad_to
    codes = np.zeros((len(seqs), l2), np.int32)
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = encode(s)
        lens[i] = len(s)
    return torch.as_tensor(codes, device=dev), torch.as_tensor(lens, device=dev)


def align_scores(
    queries: Sequence[str],
    subjects: Sequence[str],
    gap_open: float = 10.0,
    gap_extend: float = 1.0,
    pad_to: int = 32,
    device="cuda",
) -> np.ndarray:
    """(len(queries),) float32 global BLOSUM62 scores, queries[i] against
    subjects[i], on ``device``. All queries share one length (bucket
    substitutions and indels by length first)."""
    dev = resolve_device(device)
    l1 = len(queries[0])
    assert all(len(q) == l1 for q in queries)
    Q = torch.as_tensor(np.stack([encode(q) for q in queries]), device=dev)
    S, lens = _padded_codes(subjects, pad_to, dev)
    return _gotoh_scores(Q, S, lens, float(gap_open), float(gap_extend)).cpu().numpy()


def cluster_supporting_set(
    query: str,
    homologs: Sequence[str],
    identity: float = 0.75,
    max_clusters: int = 30,
    max_candidates: int = 200,
    seed: int = 0,
) -> List[List[str]]:
    """Greedy clustering of the ungapped, deduplicated homologs at
    ``identity`` 3-mer Jaccard similarity, after a seeded sample of
    ``max_candidates``; representatives in order of similarity to the
    query (the BLAST E-value order's stand-in). Up to ``max_clusters``
    member lists. Host code, the JAX package's line for line."""
    uniq = []
    seen = set()
    for h in homologs:
        h = h.upper().replace("-", "").replace(".", "")
        if h and h not in seen:
            seen.add(h)
            uniq.append(h)
    if len(uniq) > max_candidates:
        rs = np.random.RandomState(seed)
        uniq = [uniq[i] for i in rs.choice(len(uniq), max_candidates, replace=False)]

    def ident(a, b):
        """3-mer Jaccard similarity (indel-robust; CD-HIT's own candidate
        filter is k-mer based)."""
        if len(a) < 3 or len(b) < 3:
            return float(a == b)
        ka = {a[i : i + 3] for i in range(len(a) - 2)}
        kb = {b[i : i + 3] for i in range(len(b) - 2)}
        inter = len(ka & kb)
        return inter / max(len(ka | kb), 1)

    uniq.sort(key=lambda h: -ident(query, h))
    clusters: List[List[str]] = []
    for h in uniq:
        placed = False
        for cl in clusters:
            if ident(cl[0], h) >= identity:
                cl.append(h)
                placed = True
                break
        if not placed and len(clusters) < max_clusters:
            clusters.append([h])
    return clusters


def supporting_sequences(clusters: Sequence[Sequence[str]], max_per_cluster: int = 5):
    """The first ``max_per_cluster`` members of each cluster, and the
    cluster of each."""
    supporting: List[str] = []
    cluster_of: List[int] = []
    for ci, cl in enumerate(clusters):
        for s in list(cl)[:max_per_cluster]:
            supporting.append(s)
            cluster_of.append(ci)
    return supporting, np.asarray(cluster_of)


def provean_scores(
    wild_type: str,
    mutated_sequences: Sequence[str],
    clusters: Sequence[Sequence[str]],
    gap_open: float = 10.0,
    gap_extend: float = 1.0,
    max_per_cluster: int = 5,
    device="cuda",
) -> np.ndarray:
    """PROVEAN score per variant: the mean over clusters of the mean delta
    align(variant, s) - align(wt, s). Variants are bucketed by length (the
    queries of a call share l1), and each bucket's (variant, supporting)
    pairs go to the device in calls of up to ``PAIR_CELLS`` DP cells."""
    supporting, cluster_of = supporting_sequences(clusters, max_per_cluster)
    if not supporting:
        return np.zeros(len(mutated_sequences))
    dev = resolve_device(device)
    n_cl = int(cluster_of.max()) + 1
    n_sup = len(supporting)
    # each sequence encoded once; the pairs are built on the device
    S, lens = _padded_codes(supporting, 32, dev)
    wt = torch.as_tensor(encode(wild_type), device=dev)
    wt_scores = _gotoh_scores(wt.expand(n_sup, -1), S, lens, gap_open,
                              gap_extend).cpu().numpy()

    out = np.zeros(len(mutated_sequences))
    by_len: Dict[int, List[int]] = {}
    for i, s in enumerate(mutated_sequences):
        by_len.setdefault(len(s), []).append(i)
    variant_chunk = max(1, PAIR_CELLS // (n_sup * (S.shape[1] + 1)))
    for idxs in by_len.values():
        codes = torch.as_tensor(np.stack([encode(mutated_sequences[i]) for i in idxs]),
                                device=dev)
        for s0 in range(0, len(idxs), variant_chunk):
            part = idxs[s0 : s0 + variant_chunk]
            v_scores = _gotoh_scores(
                codes[s0 : s0 + len(part)].repeat_interleave(n_sup, dim=0),
                S.repeat(len(part), 1), lens.repeat(len(part)), gap_open, gap_extend,
            ).cpu().numpy().reshape(len(part), n_sup)
            delta = v_scores - wt_scores[None, :]
            per_cluster = np.zeros((len(part), n_cl))
            for ci in range(n_cl):
                per_cluster[:, ci] = delta[:, cluster_of == ci].mean(1)
            out[np.asarray(part)] = per_cluster.mean(1)
    return out
