"""Structure-conditioned masked LMs over the port's trunks (counterpart of
proteingym_tpu/models/structure_plms.py):

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
- AIDO-class (ref AIDO/compute_fitness.py:32-113): a bidirectional MoE
  masked LM (8 x 512, 8 heads of 64, 8 gated experts of 1,024, top 2,
  bf16) over ESM's alphabet: rotary in float32 rounded to bf16, attention
  through ``mha`` with the pad mask and the default scale (K1 after its
  ``rope_qk`` pre-pass on the card), the experts routed in float32
  (``progen3.moe_ffn``; the JAX function runs all of them densely, the
  function is the same). Scored with the reference's sliding masked table
  (768-residue windows, overlaps averaged in float64) at two temperatures,
  the alignment's weighted count prior blended in.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from proteingym_tpu_torch.devices import resolve_device, seeded_generator
from proteingym_tpu_torch.models import carp, esm2, progen3
from proteingym_tpu_torch.models.state_dict import copy_state_dict
from proteingym_tpu_torch.ops.flash_attention import mha
from proteingym_tpu_torch.ops.rotary import apply_rotary_bhtd

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


# ---------------------------------------------------------------------------
# AIDO-class: MoE masked LM + MSA retrieval fusion
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AidoConfig:
    name: str = "aido_rag_moe"
    num_layers: int = 8
    embed_dim: int = 512
    num_heads: int = 8
    ffn_dim: int = 1024  # per expert
    num_experts: int = 8
    top_k: int = 2
    alphabet_size: int = 33
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    def moe(self) -> progen3.ProGen3Config:
        return progen3.ProGen3Config(name=self.name, hidden_dim=self.embed_dim,
                                     ffn_dim=self.ffn_dim, num_experts=self.num_experts,
                                     top_k=self.top_k, gated_mlp=True)


class AidoLayer(nn.Module):
    def __init__(self, c: AidoConfig):
        super().__init__()
        d = c.embed_dim
        self.attn_ln = esm2.LayerNorm(d)
        self.qkv = nn.Linear(d, 3 * d, bias=False, dtype=c.dtype)
        self.out = nn.Linear(d, d, bias=False, dtype=c.dtype)
        self.ffn_ln = esm2.LayerNorm(d)
        self.moe = progen3.SparseMoeBlock(c.moe())


class Aido(nn.Module):
    """(B, T) ESM tokens -> (B, T, V) float32 logits: the JAX ``aido_apply``.
    Parameters in the JAX pytree's names (``embed``, ``layers.{i}.attn_ln``,
    ``qkv``, ``out``, ``ffn_ln``, ``moe.gate`` for the router and
    ``moe.experts.{e}.w1/w3/w2``, ``final_ln``, ``head``); the embedding and
    the projections stored in the model dtype (the JAX model's cast at
    every use, made once), norms, router, experts and head in float32."""

    def __init__(self, c: AidoConfig):
        super().__init__()
        self.config = c
        self.embed = nn.Embedding(c.alphabet_size, c.embed_dim, dtype=c.dtype)
        self.layers = nn.ModuleList(AidoLayer(c) for _ in range(c.num_layers))
        self.final_ln = esm2.LayerNorm(c.embed_dim)
        self.head = nn.Linear(c.embed_dim, c.alphabet_size, bias=False)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        c = self.config
        b, t = tokens.shape
        d, h, hd = c.embed_dim, c.num_heads, c.head_dim
        key_mask = tokens != esm2.ALPHABET.padding_idx
        x = self.embed(tokens)
        for layer in self.layers:
            q, k, v = (z.view(b, t, h, hd).transpose(1, 2)
                       for z in layer.qkv(layer.attn_ln(x)).split(d, -1))
            q, k = apply_rotary_bhtd(q, k)  # float32, rounded to the model dtype
            ctx = mha(q, k, v, key_mask=key_mask)
            x = x + layer.out(ctx.transpose(1, 2).reshape(b, t, d))
            x = x + progen3.moe_ffn(layer.ffn_ln(x), layer.moe)
        return self.head(self.final_ln(x).float())


def _empty_aido(c: AidoConfig, device) -> Aido:
    with torch.device("meta"):
        model = Aido(c)
    return model.to_empty(device=resolve_device(device)).eval().requires_grad_(False)


@torch.no_grad()
def aido_init(c: AidoConfig, seed: int = 0, device="cuda") -> Aido:
    """Seeded random weights with the JAX ``aido_init`` distribution (the
    draws differ): every matrix N(0, 0.02^2), unit norm scales, zero norm
    biases."""
    model = _empty_aido(c, device)
    dev = model.head.weight.device
    gen = seeded_generator(seed, dev)
    for name, p in model.named_parameters():
        if isinstance(model.get_submodule(name.rsplit(".", 1)[0]), esm2.LayerNorm):
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        else:
            for chunk in p.view(-1, p.shape[-1]).split(4096):
                chunk.copy_(torch.randn(tuple(chunk.shape), generator=gen, device=dev) * 0.02)
    return model


def aido_load_state_dict(state_dict, c: AidoConfig, device="cuda") -> Aido:
    return copy_state_dict(_empty_aido(c, device), state_dict, c.name)


def aido_params_from_jax(params, c: AidoConfig) -> Dict[str, torch.Tensor]:
    """The JAX ``aido_init`` pytree (numpy leaves) in ``Aido``'s names: (in,
    out) matrices become (out, in) ``Linear`` weights, the stacked (E, ...)
    experts one Linear per expert."""
    t = lambda x: torch.from_numpy(np.array(np.asarray(x, dtype=np.float32).T))  # noqa: E731
    a = lambda x: torch.from_numpy(np.array(x, dtype=np.float32))  # noqa: E731
    sd = {"embed.weight": a(params["embed"]), "final_ln.weight": a(params["final_ln"]["g"]),
          "final_ln.bias": a(params["final_ln"]["b"]), "head.weight": t(params["head"])}
    for i, layer in enumerate(params["layers"]):
        p = f"layers.{i}"
        for ln in ("attn_ln", "ffn_ln"):
            sd[f"{p}.{ln}.weight"], sd[f"{p}.{ln}.bias"] = a(layer[ln]["g"]), a(layer[ln]["b"])
        sd[f"{p}.qkv.weight"], sd[f"{p}.out.weight"] = t(layer["qkv"]), t(layer["out"])
        sd[f"{p}.moe.gate.weight"] = t(layer["router"])
        for w in ("w1", "w2", "w3"):
            for e in range(c.num_experts):
                sd[f"{p}.moe.experts.{e}.{w}.weight"] = t(layer[w][e])
    return sd


# The reference's scoring constants (ref AIDO/compute_fitness.py:96, utils/misc.py):
# 768-residue windows stepped by 768, log-softmax at 1.0 for the mutant and
# 1.5 for the WT, and the alignment's count prior blended in at 0.3
AIDO_WINDOW = 768
AIDO_STEP = 768
AIDO_TEMP_MT = 1.0
AIDO_TEMP_WT = 1.5
AIDO_RETRIEVAL_ALPHA = 0.3


def aido_sliding_starts(seq_len: int) -> list:
    """Window starts as the reference's sliding loop (ref AIDO utils/misc.py
    get_logits_table_sliding:298-306): steps of AIDO_STEP; when a step would
    overrun and the sequence is longer than the window, the last window
    snaps to the sequence's end."""
    starts = []
    for f_start in range(0, seq_len, AIDO_STEP):
        if f_start + AIDO_WINDOW > seq_len and seq_len > AIDO_WINDOW:
            starts.append(seq_len - AIDO_WINDOW)
            break
        starts.append(f_start)
    return starts


def aido_logits_table_sliding(logits_fn, res_tokens: np.ndarray, vocab_size: int, mask_id: int,
                              chunk: int = 8, positions=None) -> np.ndarray:
    """(L, V) float64 masked-logits table in residue coordinates (ref AIDO
    utils/misc.py get_logits_table_sliding:276-345): in each window every
    selected position is masked in a grid of its own, ``chunk`` grids a
    call of ``logits_fn`` ((B, W) int numpy -> (B, W, V)), the last block
    padded to ``chunk`` with unmasked copies; a position covered by several
    windows averages its logits. ``positions`` (every residue by default)
    lets a test mask a few residues of a sequence longer than the window."""
    res_tokens = np.asarray(res_tokens, np.int32)
    T = len(res_tokens)
    positions = sorted(range(T) if positions is None else set(positions))
    table = np.zeros((T, vocab_size), np.float64)
    counts = np.zeros(T, np.int64)
    for f_start in aido_sliding_starts(T):
        win = res_tokens[f_start:min(f_start + AIDO_WINDOW, T)]
        pos_in = [p for p in positions if f_start <= p < f_start + len(win)]
        for blk in range(0, len(pos_in), chunk):
            idx = np.asarray(pos_in[blk:blk + chunk])
            grids = np.tile(win, (chunk, 1))
            grids[np.arange(len(idx)), idx - f_start] = mask_id
            logits = logits_fn(grids)
            rows = logits[np.arange(len(idx)), idx - f_start]
            rows = rows.double().cpu().numpy() if torch.is_tensor(rows) else np.asarray(rows)
            for bi, p in enumerate(idx):
                table[p] += rows[bi]
                counts[p] += 1
    return table / np.maximum(counts, 1)[:, None]


def aido_scores_from_table(sequence: str, table: np.ndarray, mutants: Sequence[str],
                           aa_to_idx) -> np.ndarray:
    """The reference's score assembly (ref AIDO utils/misc.py
    get_scores_from_table:347-382): the averaged table through log-softmax
    at AIDO_TEMP_MT and AIDO_TEMP_WT, the sum over sub-mutants (positions
    from 1) of table_mt[pos, mt] - table_wt[pos, wt], in float64. A literal
    WT row raises."""

    def log_softmax(z, temp):
        z = np.asarray(z, np.float64) / temp
        z = z - z.max(-1, keepdims=True)
        return z - np.log(np.exp(z).sum(-1, keepdims=True))

    table_mt, table_wt = log_softmax(table, AIDO_TEMP_MT), log_softmax(table, AIDO_TEMP_WT)
    out = np.zeros(len(mutants))
    for i, m in enumerate(mutants):
        for tok in str(m).split(":"):
            wt, pos, mt = tok[0], int(tok[1:-1]) - 1, tok[-1]
            if sequence[pos] != wt:
                raise ValueError(f"WT mismatch in {tok}")
            out[i] += table_mt[pos, aa_to_idx[mt]] - table_wt[pos, aa_to_idx[wt]]
    return out


def aido_logits_table(model: Aido, sequence: str, chunk: int) -> np.ndarray:
    """The residue-coordinate masked table of ``sequence`` over the model:
    ``aido_logits_table_sliding`` with CLS and EOS around each window."""
    al = esm2.ALPHABET
    dev = model.head.weight.device

    @torch.no_grad()
    def logits_fn(grids: np.ndarray) -> torch.Tensor:
        full = np.full((grids.shape[0], grids.shape[1] + 2), al.eos_idx, np.int64)
        full[:, 0] = al.cls_idx
        full[:, 1:-1] = grids
        return model(torch.as_tensor(full, device=dev))[:, 1:-1]

    res_tokens = np.asarray([al.get_idx(a) for a in sequence], np.int32)
    return aido_logits_table_sliding(logits_fn, res_tokens, model.config.alphabet_size,
                                     al.mask_idx, chunk=chunk)


def aido_score_assay(model: Aido, sequence: str, mutants: Sequence[str],
                     msa_sequences: Optional[Sequence[str]] = None,
                     msa_weights: Optional[np.ndarray] = None, chunk: int = 8) -> np.ndarray:
    """The sliding table, its amino-acid columns blended with the
    alignment's weighted count prior at AIDO_RETRIEVAL_ALPHA (standing in
    for the 16B model's in-context retrieval), then scored."""
    al = esm2.ALPHABET
    table = aido_logits_table(model, sequence, chunk)
    if msa_sequences:
        aa_cols = np.asarray([al.get_idx(a) for a in AA20])
        rows = np.arange(len(sequence))
        prior = alignment_count_logits(msa_sequences, msa_weights)
        table[np.ix_(rows, aa_cols)] = ((1 - AIDO_RETRIEVAL_ALPHA) * table[np.ix_(rows, aa_cols)]
                                        + AIDO_RETRIEVAL_ALPHA * prior)
    return aido_scores_from_table(sequence, table, mutants, {a: al.get_idx(a) for a in AA20})
