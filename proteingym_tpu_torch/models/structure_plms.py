"""Structure-conditioned masked LMs over the port's trunks (counterpart of
proteingym_tpu/models/structure_plms.py, without AIDO):

- MIF / MIF-ST (ref carp_mif/compute_fitness.py:31-48): the CARP ByteNet
  trunk with a per-residue structure projection added to its embeddings;
  the features are the mean RBF distance profile of each residue's 16
  nearest neighbours (``ops/gnn.knn_graph``) and its backbone dihedrals
  (``ops/gvp``). WT-forward marginals, each mutant's sum divided by its
  number of positions.
- the legacy additive MULAN (``method=additive``): an ESM2 trunk with a
  linear adapter of the backbone dihedrals added to its embeddings;
  masked marginals.
- the legacy VenusREM blend (``method=esm``): an ESM2 masked-marginal
  table plus alpha x the log-frequencies of the residue alignment and
  beta x those of a structure alignment.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from proteingym_tpu_torch.devices import resolve_device, seeded_generator
from proteingym_tpu_torch.models import carp, esm2
from proteingym_tpu_torch.models.state_dict import copy_state_dict

AA20 = "ACDEFGHIKLMNPQRSTVWY"


def conditioned_table(model: esm2.EsmModel, tokens: np.ndarray, cond: torch.Tensor,
                      chunk: int) -> torch.Tensor:
    """The masked-marginal (T, V) table of ``model`` with the per-position
    ``cond`` (T, D) added to its embeddings. The window is the whole row:
    a sliced window would misalign the conditioning, which the trunk adds
    from position 0."""
    from proteingym_tpu_torch.models.esm_scoring import masked_marginal_table

    return masked_marginal_table(lambda rows: model(rows, extra_embedding=cond), tokens,
                                 mask_idx=esm2.ALPHABET.mask_idx, chunk=chunk,
                                 window=len(tokens), device=cond.device)


# ---------------------------------------------------------------------------
# MIF: CARP trunk + structure features
# ---------------------------------------------------------------------------

MIF_PRESETS = {
    "mif": carp.CarpConfig("mif", 8, 256, max_dilation=32),
    "mif_st": carp.CarpConfig("mif_st", 16, 512, max_dilation=64),
}
MIF_FEAT_DIM = 25  # 16 RBF + 3 offset features, 6 dihedral sin/cos


def mif_structure_features(coords: np.ndarray, num_rbf: int = 16,
                           k_neighbors: int = 16) -> np.ndarray:
    """(L, 4, 3) backbone -> (L, num_rbf + 9) float32: the mean over each
    residue's k nearest neighbours (by CA, in float32) of its edge
    features, then its dihedral sin/cos."""
    from proteingym_tpu_torch.ops.gnn import knn_graph
    from proteingym_tpu_torch.ops.gvp import backbone_edge_features, backbone_node_features

    e_idx = knn_graph(torch.as_tensor(coords[:, 1], dtype=torch.float32), k_neighbors).numpy()
    edge_s, _ = backbone_edge_features(coords, e_idx, num_rbf)
    node_s, _ = backbone_node_features(coords)
    return np.concatenate([edge_s.mean(1), node_s], -1).astype(np.float32)


class Mif(carp.Carp):
    """CARP (native layout, the zenodo names) with ``struct_proj``, a
    float32 Linear(feat_dim -> d) of the structure features whose output is
    added to the embeddings: (1, T) tokens and (T, F) features -> (1, T, V)
    float32 logits."""

    def __init__(self, config: carp.CarpConfig, feat_dim: int = MIF_FEAT_DIM):
        super().__init__(config, carp.native_layout(config))
        self.struct_proj = nn.Linear(feat_dim, config.embed_dim)

    def forward(self, tokens, struct_feats):
        cond = struct_feats @ self.struct_proj.weight.t() + self.struct_proj.bias
        return super().forward(tokens, extra_embedding=cond)


def _empty_mif(config, feat_dim, device) -> Mif:
    with torch.device("meta"):
        model = Mif(config, feat_dim)
    return model.to_empty(device=resolve_device(device)).eval().requires_grad_(False)


@torch.no_grad()
def mif_init(config: carp.CarpConfig, feat_dim: int = MIF_FEAT_DIM, seed: int = 0,
             device="cuda") -> Mif:
    """Seeded random weights: CARP's ``init_random`` draws, the projection
    N(0, 0.02^2) from a second stream and a zero bias (the JAX ``mif_init``
    distribution; the draws differ)."""
    model = carp.fill_random(_empty_mif(config, feat_dim, device), seed)
    w = model.struct_proj.weight
    w.copy_(torch.randn(tuple(w.shape), generator=seeded_generator(seed, w.device, 1),
                        device=w.device) * 0.02)
    model.struct_proj.bias.zero_()
    return model


@torch.no_grad()
def mif_load_state_dict(state_dict, config: carp.CarpConfig, device="cuda") -> Mif:
    """The model from a state dict in its own names (``Mif.state_dict()``:
    CARP's zenodo names of the native layout and ``struct_proj``)."""
    feat_dim = int(np.shape(state_dict["struct_proj.weight"])[1])
    return copy_state_dict(_empty_mif(config, feat_dim, device), state_dict, config.name)


def mif_params_from_jax(params, config: carp.CarpConfig):
    """The JAX ``mif_init`` pytree (numpy leaves) in the model's names."""
    sd = carp.params_from_jax(params, config)
    sd["struct_proj.weight"] = torch.from_numpy(
        np.array(np.asarray(params["struct_proj"]["w"]).T, dtype=np.float32))
    sd["struct_proj.bias"] = torch.from_numpy(np.array(params["struct_proj"]["b"], np.float32))
    return sd


def mif_score_assay(model: Mif, coords: np.ndarray, sequence: str, mutants: Sequence[str],
                    offset_idx: int = 1) -> np.ndarray:
    """WT-forward marginals conditioned on the structure (ref label_row):
    each mutant's sum of log p(mt) - log p(wt) over its positions, divided
    by their number. A literal WT row raises, as in the JAX function."""
    tok = carp.CarpTokenizer()
    dev = model.decoder.conv.weight.device
    feats = torch.as_tensor(mif_structure_features(coords), device=dev)
    tokens = torch.as_tensor(tok.encode(sequence)[None], dtype=torch.long, device=dev)
    with torch.no_grad():
        logps = torch.log_softmax(model(tokens, feats).float(), -1)[0].cpu().numpy()
    out = np.zeros(len(mutants))
    for i, m in enumerate(mutants):
        toks = m.split(":")
        for t in toks:
            wt, pos, mt = t[0], int(t[1:-1]) - offset_idx, t[-1]
            if sequence[pos] != wt:
                raise ValueError(f"WT mismatch in {t}")
            out[i] += logps[pos, tok.get_idx(mt)] - logps[pos, tok.get_idx(wt)]
        out[i] /= len(toks)
    return out


# ---------------------------------------------------------------------------
# The legacy additive MULAN: ESM2 + a dihedral adapter
# ---------------------------------------------------------------------------


class AngleConditionedEsm(nn.Module):
    """An ESM2 trunk (``esm``) and ``angle_adapter``, a float32 Linear(6 ->
    d) of the dihedral sin/cos."""

    def __init__(self, esm: esm2.EsmModel):
        super().__init__()
        self.esm = esm
        self.angle_adapter = nn.Linear(6, esm.config.embed_dim,
                                       device=esm.embed_tokens.weight.device)


@torch.no_grad()
def mulan_init(esm_config: esm2.EsmConfig, seed: int = 0, device="cuda") -> AngleConditionedEsm:
    """Seeded random weights: ``esm2.init_random`` and the adapter
    N(0, 0.02^2) from a second stream, zero bias."""
    model = AngleConditionedEsm(esm2.init_random(esm_config, seed=seed, device=device))
    w = model.angle_adapter.weight
    w.copy_(torch.randn(tuple(w.shape), generator=seeded_generator(seed, w.device, 1),
                        device=w.device) * 0.02)
    model.angle_adapter.bias.zero_()
    return model.eval().requires_grad_(False)


def mulan_score_assay(model: AngleConditionedEsm, coords: np.ndarray, sequence: str,
                      mutants: Sequence[str], chunk: int = 16) -> np.ndarray:
    """Masked marginals with the adapter's dihedral embedding added at the
    residues (zero at CLS and EOS)."""
    from proteingym_tpu_torch.models.esm_scoring import score_mutants_from_table
    from proteingym_tpu_torch.ops.gvp import backbone_node_features

    ad = model.angle_adapter
    node_s, _ = backbone_node_features(coords)
    cond = torch.as_tensor(node_s, device=ad.weight.device) @ ad.weight.t() + ad.bias
    cond_full = torch.zeros(len(sequence) + 2, cond.shape[1], device=cond.device)
    cond_full[1:1 + len(sequence)] = cond
    table = conditioned_table(model.esm, esm2.ALPHABET.tokenize(sequence), cond_full, chunk)
    return score_mutants_from_table(table, mutants, sequence)


# ---------------------------------------------------------------------------
# The legacy VenusREM blend
# ---------------------------------------------------------------------------


def alignment_count_logits(sequences: Sequence[str], weights: Optional[np.ndarray] = None,
                           pseudocount: float = 0.5) -> np.ndarray:
    """(L, 20) log-frequencies of the amino acids in each column of the
    aligned strings, ``pseudocount`` added, rows weighted by ``weights``."""
    L = len(sequences[0])
    aa_idx = {a: i for i, a in enumerate(AA20)}
    if weights is None:
        weights = np.ones(len(sequences))
    counts = np.full((L, 20), pseudocount)
    for w, s in zip(weights, sequences):
        for j, ch in enumerate(s.upper()):
            k = aa_idx.get(ch)
            if k is not None:
                counts[j, k] += w
    return np.log(counts / counts.sum(1, keepdims=True))


def venusrem_score_assay(model: esm2.EsmModel, sequence: str, mutants: Sequence[str],
                         seq_alignment: Optional[Sequence[str]] = None,
                         struct_alignment: Optional[Sequence[str]] = None, alpha: float = 0.8,
                         beta: float = 0.2, chunk: int = 16) -> np.ndarray:
    """The masked-marginal table plus alpha x the residue alignment's and
    beta x the structure alignment's log-frequencies at the residues'
    amino-acid columns."""
    from proteingym_tpu_torch.models.esm_scoring import (
        masked_marginal_table, score_mutants_from_table,
    )

    tokens = esm2.ALPHABET.tokenize(sequence)
    table = masked_marginal_table(model, tokens, mask_idx=esm2.ALPHABET.mask_idx,
                                  chunk=chunk).cpu().numpy()
    aa_cols = np.asarray([esm2.ALPHABET.get_idx(a) for a in AA20])
    rows = np.arange(1, 1 + len(sequence))
    if seq_alignment:
        table[np.ix_(rows, aa_cols)] += alpha * alignment_count_logits(seq_alignment)
    if struct_alignment:
        table[np.ix_(rows, aa_cols)] += beta * alignment_count_logits(struct_alignment)
    return score_mutants_from_table(table, mutants, sequence)
