"""3Di-style structure tokens: geometric descriptors and a VQ codebook, in
numpy (counterpart of proteingym_tpu/ops/tridi.py, the native replacement
for the foldseek binary the reference shells out to; ref
saprot/foldseek_util.py).

For each residue i the interaction partner j is its nearest residue by
virtual-centre distance; the descriptor couples the local backbone
geometry of i and j:

  u1 = cos(Ca_{i-1}->Ca_i, Ca_j->Ca_{j+1})     u4 = cos(Ca_{i-1}->Ca_i, Ca_i->Ca_j)
  u2 = cos(Ca_i->Ca_{i+1}, Ca_{j-1}->Ca_j)     u5 = cos(Ca_{j-1}->Ca_j, Ca_i->Ca_j)
  u3 = cos(Ca_{i-1}->Ca_i, Ca_{j-1}->Ca_j)     d  = |Ca_i - Ca_j| (clamped /20)
  plus clamped signed sequence-offset features of (j - i)

and a token is the nearest of 20 centroids of a codebook (``train_codebook``
k-means, ``default_codebook`` over synthetic helices, or a published one).
The virtual CB is ProteinMPNN's (``models/protein_mpnn.virtual_cb``),
computed in float32 on the CPU as the JAX package computes it; everything
after it is float64 numpy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

TRIDI_VOCAB = "pynwrqhgdlvtmfsaeikc"  # foldseek's 20 3Di letters


def _unit(v, eps=1e-8):
    return v / (np.linalg.norm(v, axis=-1, keepdims=True) + eps)


def virtual_center(ca: np.ndarray, cb: np.ndarray) -> np.ndarray:
    """Foldseek's virtual interaction centre: the CB direction scaled from CA."""
    return ca + 1.5 * (cb - ca)


def tridi_descriptors(coords: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """coords (L, 4, 3) N/CA/C/O -> ((L, 10) descriptors, (L,) partners)."""
    from proteingym_tpu_torch.models.protein_mpnn import virtual_cb

    n = coords.shape[0]
    ca = coords[:, 1]
    vc = virtual_center(ca, virtual_cb(torch.as_tensor(coords, dtype=torch.float32)).numpy())
    d2 = ((vc[:, None] - vc[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    partner = d2.argmin(1)

    def seg(idx):
        return (_unit(ca[idx] - ca[np.maximum(idx - 1, 0)]),
                _unit(ca[np.minimum(idx + 1, n - 1)] - ca[idx]))

    prev_i, next_i = seg(np.arange(n))
    prev_j, next_j = seg(partner)
    rel = ca[partner] - ca
    rel_u = _unit(rel)
    offset = partner - np.arange(n)
    return np.stack([
        (prev_i * next_j).sum(-1), (next_i * prev_j).sum(-1), (prev_i * prev_j).sum(-1),
        (prev_i * rel_u).sum(-1), (prev_j * rel_u).sum(-1),
        np.clip(np.linalg.norm(rel, axis=-1), 0, 20.0) / 20.0,
        np.clip(offset, -4, 4) / 4.0, np.sign(offset), np.clip(np.abs(offset), 0, 16.0) / 16.0,
        (next_i * next_j).sum(-1),
    ], -1), partner


def train_codebook(descriptors: np.ndarray, k: int = 20, iters: int = 50,
                   seed: int = 0) -> np.ndarray:
    """k-means centroids over (N, 10) descriptors."""
    rs = np.random.RandomState(seed)
    x = np.asarray(descriptors, np.float64)
    centroids = x[rs.choice(len(x), k, replace=len(x) < k)]
    for _ in range(iters):
        assign = ((x[:, None] - centroids[None]) ** 2).sum(-1).argmin(1)
        for c in range(k):
            pts = x[assign == c]
            if len(pts):
                centroids[c] = pts.mean(0)
    return centroids


def default_codebook(k: int = 20) -> np.ndarray:
    """The deterministic fallback codebook, trained on four synthetic helices
    of 64 residues with seeded noise of 0, 0.3, 0.6 and 0.9 A; a published
    codebook gives foldseek-parity tokens."""
    from proteingym_tpu_torch.data.structures import synthetic_helix_backbone

    descs = []
    for seed in range(4):
        coords = synthetic_helix_backbone(64, seed=seed)
        coords = coords + np.random.RandomState(seed).randn(*coords.shape) * (0.3 * seed)
        descs.append(tridi_descriptors(coords)[0])
    return train_codebook(np.concatenate(descs), k=k, seed=0)


def structure_tokens(coords: np.ndarray, codebook: Optional[np.ndarray] = None) -> np.ndarray:
    """(L, 4, 3) backbone -> (L,) 3Di state ids in [0, 20)."""
    if codebook is None:
        codebook = default_codebook()
    desc, _ = tridi_descriptors(coords)
    return ((desc[:, None] - codebook[None]) ** 2).sum(-1).argmin(1).astype(np.int32)


def structure_letters(coords: np.ndarray, codebook: Optional[np.ndarray] = None) -> str:
    return "".join(TRIDI_VOCAB[t] for t in structure_tokens(coords, codebook))
