"""SaProt: the structure-aware masked LM over (residue x 3Di) tokens
(counterpart of proteingym_tpu/models/saprot.py; ref
proteingym/baselines/saprot/compute_fitness.py:17-75):

- the vocabulary: 5 specials, then one 21-wide block per sequence letter
  (the 20 amino acids, X and the masked residue '#'), each block the 20
  3Di letters and the masked 3Di '#';
- a token is pair(residue_i, 3Di_i), the 3Di string from the backbone
  (``ops/tridi.py``) or given;
- scoring: the residue half masked ('#' + 3Di) at every mutated position,
  one forward a mutant, p(residue = X) the sum of the softmax over X's
  21-wide block, score = sum log(p_mt / p_wt) (:43-55).

The trunk is the port's ESM2 (``models/esm2.py``, bf16, K4 on the card)
with the enlarged vocabulary; like the JAX package's, its token dropout
keys on ESM's own mask index. Published fair-esm-format state dicts load
through ``esm2.load_fair_esm_state_dict``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from proteingym_tpu_torch.models import esm2
from proteingym_tpu_torch.ops.tridi import TRIDI_VOCAB, structure_letters

SEQ_CHARS = "ACDEFGHIKLMNPQRSTVWYX#"  # amino acids, unknown, masked residue
N_SPECIALS = 5  # <cls> <pad> <eos> <unk> <mask>
BLOCK = len(TRIDI_VOCAB) + 1  # each sequence letter also pairs with the masked 3Di '#'
STRUC_CHARS = TRIDI_VOCAB + "#"
AA_LETTERS = "ACDEFGHIKLMNPQRSTVWYX"  # the letters a mutant may name, unknown as X


class SaProtVocab:
    cls_idx, padding_idx, eos_idx, unk_idx, mask_idx = 0, 1, 2, 3, 4

    def __init__(self):
        self.pair_base = {}
        idx = N_SPECIALS
        for s in SEQ_CHARS:
            self.pair_base[s] = idx
            idx += BLOCK
        self.size = idx

    def pair_id(self, aa: str, tridi: str) -> int:
        aa = aa if aa in self.pair_base else "X"
        si = STRUC_CHARS.index(tridi) if tridi in STRUC_CHARS else BLOCK - 1
        return self.pair_base[aa] + si

    def tokenize(self, seq: str, struc: str) -> np.ndarray:
        if len(seq) != len(struc):
            raise ValueError(f"sequence of {len(seq)} and 3Di string of {len(struc)} letters")
        return np.asarray([self.cls_idx] + [self.pair_id(a, s) for a, s in zip(seq, struc)]
                          + [self.eos_idx], dtype=np.int64)

    def aa_block(self, aa: str) -> slice:
        base = self.pair_base[aa if aa in self.pair_base else "X"]
        return slice(base, base + BLOCK)


VOCAB = SaProtVocab()


class SaProtFileVocab:
    """The vocabulary of a published SaProt ``vocab.txt``. The per-residue
    21-wide 3Di blocks must be contiguous in it, as the reference assumes
    (compute_fitness.py:47-51); a file that breaks that raises."""

    # foldseek's 3Di letters in the reference's order (compute_fitness.py:14)
    struc_chars = "pynwrqhgdlvtmfsaeikc#"

    def __init__(self, path):
        with open(path) as f:
            toks = [line.strip() for line in f if line.strip()]
        self.tok_to_idx = {t: i for i, t in enumerate(toks)}
        self.size = len(toks)
        self.cls_idx = self.tok_to_idx.get("<cls>", 0)
        self.padding_idx = self.tok_to_idx.get("<pad>", 1)
        self.eos_idx = self.tok_to_idx.get("<eos>", 2)
        self.unk_idx = self.tok_to_idx.get("<unk>", 3)
        self.mask_idx = self.tok_to_idx.get("<mask>", self.size - 1)
        for aa in "ACDEFGHIKLMNPQRSTVWY#":
            base = self.tok_to_idx.get(aa + self.struc_chars[0])
            if base is None:
                continue
            for j, sc in enumerate(self.struc_chars):
                tid = self.tok_to_idx.get(aa + sc)
                if tid is not None and tid != base + j:
                    raise ValueError(f"vocab file breaks the contiguous 3Di-block "
                                     f"assumption at {aa}{sc}")

    def pair_id(self, aa, tridi):
        tok = aa + (tridi if tridi in self.struc_chars else "#")
        if tok not in self.tok_to_idx:
            tok = "#" + (tridi if tridi in self.struc_chars else "#")
        return self.tok_to_idx.get(tok, self.unk_idx)

    def tokenize(self, seq, struc):
        if len(seq) != len(struc):
            raise ValueError(f"sequence of {len(seq)} and 3Di string of {len(struc)} letters")
        return np.asarray([self.cls_idx] + [self.pair_id(a, s) for a, s in zip(seq, struc)]
                          + [self.eos_idx], dtype=np.int64)

    def aa_block(self, aa):
        base = self.tok_to_idx.get(aa + self.struc_chars[0])
        if base is None:
            base = self.tok_to_idx["#" + self.struc_chars[0]]
        return slice(base, base + len(self.struc_chars))


def saprot_config(preset: str = "saprot_650M") -> esm2.EsmConfig:
    """ESM2-35M or -650M over SaProt's vocabulary (bf16)."""
    base = {"saprot_35M": esm2.PRESETS["esm2_t12_35M"],
            "saprot_650M": esm2.PRESETS["esm2_t33_650M"]}[preset]
    return dataclasses.replace(base, name=preset, alphabet_size=VOCAB.size)


PRESETS = {name: saprot_config(name) for name in ("saprot_35M", "saprot_650M")}


def _block_ids(vocab) -> torch.Tensor:
    """(len(AA_LETTERS), block) token ids of each letter's 3Di block."""
    return torch.as_tensor(np.stack([np.arange(vocab.aa_block(a).start, vocab.aa_block(a).stop)
                                     for a in AA_LETTERS]))


@torch.no_grad()
def score_mutants(model: esm2.EsmModel, target_seq: str, struc_seq: str,
                  mutants: Sequence[str], vocab=None, offset_idx: int = 1,
                  batch_size: int = 8) -> np.ndarray:
    """Each mutant's masked forward and 3Di-block marginals: the sum over
    its positions of log(p_mt / p_wt), each p the softmax mass of the
    letter's 21-wide block at the masked position. Rows are PAD-filled to
    the longest."""
    vocab = vocab or VOCAB
    dev = next(model.parameters()).device
    rows, sites = [], []
    for m in mutants:
        seq, site = list(target_seq), []
        for tok in m.split(":"):
            pos = int(tok[1:-1]) - offset_idx
            if target_seq[pos] != tok[0]:
                raise ValueError(f"WT mismatch in {tok}")
            seq[pos] = "#"  # mask the residue half, keep the 3Di half
            site.append((pos + 1, tok[0], tok[-1]))  # +1 for <cls>
        rows.append(vocab.tokenize("".join(seq), struc_seq))
        sites.append(site)
    t = max(len(r) for r in rows)
    blocks = _block_ids(vocab).to(dev)
    letter = {a: i for i, a in enumerate(AA_LETTERS)}
    out = np.zeros(len(mutants))
    for s0 in range(0, len(rows), batch_size):
        blk = rows[s0:s0 + batch_size]
        tok = np.full((len(blk), t), vocab.padding_idx, np.int64)
        for i, r in enumerate(blk):
            tok[i, :len(r)] = r
        probs = torch.softmax(model(torch.as_tensor(tok, device=dev)).float(), -1)
        mass = probs[..., blocks].sum(-1).cpu().numpy()  # (B, T, letters)
        for i, site in enumerate(sites[s0:s0 + len(blk)]):
            score = 0.0
            for at, wt, mt in site:
                p_wt = mass[i, at, letter.get(wt, letter["X"])]
                p_mt = mass[i, at, letter.get(mt, letter["X"])]
                score += np.log(p_mt / max(p_wt, 1e-30))
            out[s0 + i] = score
    return out


def score_assay_saprot(model: esm2.EsmModel, target_seq: str, coords: Optional[np.ndarray],
                       mutants: Sequence[str], struc_seq: Optional[str] = None,
                       codebook: Optional[np.ndarray] = None, batch_size: int = 8,
                       vocab=None) -> np.ndarray:
    """3Di letters from the (L, 4, 3) backbone (or the given string), then
    masked scoring (ref calc_fitness :58-75)."""
    if struc_seq is None:
        struc_seq = structure_letters(coords, codebook)
    return score_mutants(model, target_seq, struc_seq, mutants, batch_size=batch_size,
                         vocab=vocab)
