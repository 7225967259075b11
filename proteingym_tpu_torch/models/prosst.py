"""ProSST, the masked LM over a residue stream and a quantized structure
stream with sequence-structure disentangled attention, and VenusREM's
alignment blend over it (counterpart of proteingym_tpu/models/prosst.py;
ref proteingym/baselines/prosst/compute_fitness.py:15-120 and
venusrem/compute_fitness.py:39-226).

- ``ProSST``: a DeBERTa-v1-style post-LN encoder whose attention sums five
  terms, content-content, content-to-position and position-to-content
  (DeBERTa v1's gathers over a clipped relative span), content-to-structure
  and structure-to-content (per-position structure-token embeddings),
  scaled by 1/sqrt(5 d_head); float32 throughout, in plain PyTorch
  products and ``torch.gather`` (the JAX package computes it in XLA, with
  no Pallas kernel). Parameters carry the HuggingFace names of
  AI4Protein/ProSST-{K} (``prosst.``, ``cls.predictions.``);
  ``load_hf_state_dict`` reads the split or the fused ``in_proj`` layout.
- ``score_assay_prosst_real``: one unmasked forward of the WT with the
  structure stream fixed, score = sum of log p(mt) - log p(wt).
- VenusREM: ProSST's log-probs blended with the log-softmax of alignment
  column distributions (``venusrem_score_assay_real``).
- the legacy additive scorer (``method=additive``): an ESM2 trunk with a
  per-position structure-state embedding added to its token embeddings,
  the states from a k-means codebook over the 3Di descriptors
  (``ops/tridi.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from proteingym_tpu_torch.data.mutants import is_wt_row
from proteingym_tpu_torch.devices import resolve_device, seeded_generator
from proteingym_tpu_torch.models import esm2
from proteingym_tpu_torch.models.state_dict import Named, copy_state_dict

# ---------------------------------------------------------------------------
# The legacy additive scorer (method=additive)
# ---------------------------------------------------------------------------


class StructureConditionedEsm(nn.Module):
    """An ESM2 trunk (``esm``) and ``structure_embed``, one row per
    structure state plus a last "no structure" row for the CLS/EOS slots."""

    def __init__(self, esm: esm2.EsmModel, n_rows: int):
        super().__init__()
        self.esm = esm
        self.structure_embed = nn.Parameter(torch.empty(
            n_rows, esm.config.embed_dim, device=esm.embed_tokens.weight.device))


@torch.no_grad()
def prosst_init(esm_config: esm2.EsmConfig, k_structure: int = 2048, seed: int = 0,
                device="cuda") -> StructureConditionedEsm:
    """Seeded random weights: the ESM2 trunk's ``esm2.init_random`` and the
    structure table N(0, 0.02^2) from a second generator stream (the JAX
    ``prosst_init`` distribution; the draws differ)."""
    model = StructureConditionedEsm(esm2.init_random(esm_config, seed=seed, device=device),
                                    k_structure + 1)
    w = model.structure_embed
    w.copy_(torch.randn(tuple(w.shape), generator=seeded_generator(seed, w.device, 1),
                        device=w.device) * 0.02)
    return model.eval().requires_grad_(False)


def structure_token_ids(coords: np.ndarray, k_structure: int, seed: int = 0) -> np.ndarray:
    """The backbone quantized into min(K, L) states: k-means over its 3Di
    descriptors, each residue its nearest centroid."""
    from proteingym_tpu_torch.ops.tridi import train_codebook, tridi_descriptors

    desc, _ = tridi_descriptors(coords)
    codebook = train_codebook(desc, k=min(k_structure, len(desc)), seed=seed)
    d = ((desc[:, None] - codebook[None]) ** 2).sum(-1)
    return d.argmin(1).astype(np.int32)


def score_assay_prosst(model: StructureConditionedEsm, coords: np.ndarray, sequence: str,
                       mutants: Sequence[str], k_structure: int = 2048,
                       struct_tokens: Optional[np.ndarray] = None, chunk: int = 16) -> np.ndarray:
    """Masked marginals conditioned on the fixed structure-state stream,
    added from position 0 of the full-length token row (the table's window
    is the whole row, so no slice misaligns it)."""
    from proteingym_tpu_torch.models.esm_scoring import score_mutants_from_table
    from proteingym_tpu_torch.models.structure_plms import conditioned_table

    if struct_tokens is None:
        struct_tokens = structure_token_ids(coords, k_structure)
    L = len(sequence)
    null = model.structure_embed.shape[0] - 1
    grid = np.full(L + 2, null, np.int64)
    grid[1:1 + L] = struct_tokens[:L]
    cond = model.structure_embed[torch.as_tensor(grid, device=model.structure_embed.device)]
    table = conditioned_table(model.esm, esm2.ALPHABET.tokenize(sequence), cond, chunk)
    return score_mutants_from_table(table, mutants, sequence)


# ---------------------------------------------------------------------------
# ProSST
# ---------------------------------------------------------------------------

# the residue vocabulary: 4 specials, the 20 amino acids, X
PROSST_TOKENS = ["[PAD]", "[CLS]", "[SEP]", "[UNK]"] + list("ACDEFGHIKLMNPQRSTVWY") + ["X"]
PROSST_IDX = {t: i for i, t in enumerate(PROSST_TOKENS)}
P_PAD, P_CLS, P_SEP, P_UNK = 0, 1, 2, 3


def tokenize_prosst(seq: str) -> np.ndarray:
    return np.asarray([P_CLS] + [PROSST_IDX.get(c, P_UNK) for c in seq] + [P_SEP], np.int64)


def tokenize_structure_sequence(tokens) -> np.ndarray:
    """[1] + (t + 3 for each structure token) + [2] (ref compute_fitness.py:20-28)."""
    return np.asarray([1] + [int(t) + 3 for t in tokens] + [2], np.int64)


@dataclasses.dataclass(frozen=True)
class ProSSTConfig:
    name: str = "prosst_2048"
    vocab_size: int = 25
    ss_vocab_size: int = 2048 + 3
    hidden: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate: int = 3072
    max_relative_positions: int = 1024
    scale_factor: int = 5  # content + c2p + p2c + c2ss + ss2c

    @property
    def head_dim(self) -> int:
        return self.hidden // self.num_heads


PROSST_PRESETS: Dict[str, ProSSTConfig] = {
    **{f"prosst_{k}": ProSSTConfig(name=f"prosst_{k}", ss_vocab_size=k + 3)
       for k in (20, 128, 512, 1024, 2048, 4096)},
    "prosst_tiny": ProSSTConfig(name="prosst_tiny", ss_vocab_size=16 + 3, hidden=48,
                                num_layers=2, num_heads=4, intermediate=96,
                                max_relative_positions=16),
}

LN_EPS = 1e-7  # DeBERTa's layer_norm_eps


def _dense_ln(d: int) -> Named:
    return Named(dense=nn.Linear(d, d), LayerNorm=nn.LayerNorm(d, eps=LN_EPS))


class DisentangledSelfAttention(nn.Module):
    """``attention.self``: q/k/v, the positional pair (``pos_proj`` without
    a bias, ``pos_q_proj``) and the structural pair (``ss_proj``,
    ``ss_q_proj``)."""

    def __init__(self, c: ProSSTConfig):
        super().__init__()
        d = c.hidden
        self.config = c
        self.query_proj, self.key_proj, self.value_proj = (nn.Linear(d, d) for _ in range(3))
        self.pos_proj = nn.Linear(d, d, bias=False)
        self.pos_q_proj = nn.Linear(d, d)
        self.ss_proj = nn.Linear(d, d, bias=False)
        self.ss_q_proj = nn.Linear(d, d)

    def forward(self, x, ss, rel_emb, key_mask=None):
        """Paper eq. 3 with DeBERTa v1's gathers: (B, T, D) -> (B, T, D)
        context, before the output dense."""
        c = self.config
        b, t, d = x.shape
        h = c.num_heads
        scale = math.sqrt(c.head_dim * c.scale_factor)

        def heads(y):  # (..., T, D) -> (..., H, T, hd)
            return y.view(*y.shape[:-1], h, c.head_dim).transpose(-3, -2)

        q = heads(self.query_proj(x)) / scale
        k = heads(self.key_proj(x))
        v = heads(self.value_proj(x))
        scores = q @ k.transpose(-1, -2)

        span = min(t, c.max_relative_positions)
        rel = rel_emb[c.max_relative_positions - span:c.max_relative_positions + span]
        rel_pos = torch.arange(t, device=x.device)[:, None] - torch.arange(t, device=x.device)
        c2p = q @ heads(self.pos_proj(rel)).transpose(-1, -2)  # (B, H, T, 2 span)
        c2p_pos = (rel_pos + span).clamp(0, 2 * span - 1).expand(b, h, t, t)
        p2c = k @ (heads(self.pos_q_proj(rel)) / scale).transpose(-1, -2)
        p2c_pos = (-rel_pos + span).clamp(0, 2 * span - 1).expand(b, h, t, t)
        scores = scores + torch.gather(c2p, -1, c2p_pos) \
            + torch.gather(p2c, -1, p2c_pos).transpose(-1, -2)

        scores = scores + q @ heads(self.ss_proj(ss)).transpose(-1, -2)
        scores = scores + (heads(self.ss_q_proj(ss)) / scale) @ k.transpose(-1, -2)
        if key_mask is not None:
            scores = scores.masked_fill(~key_mask[:, None, None, :], -1e9)
        ctx = torch.softmax(scores, -1) @ v
        return ctx.transpose(1, 2).reshape(b, t, d)


class ProSSTLayer(nn.Module):
    def __init__(self, c: ProSSTConfig):
        super().__init__()
        self.attention = Named(self=DisentangledSelfAttention(c), output=_dense_ln(c.hidden))
        self.intermediate = Named(dense=nn.Linear(c.hidden, c.intermediate))
        self.output = Named(dense=nn.Linear(c.intermediate, c.hidden),
                             LayerNorm=nn.LayerNorm(c.hidden, eps=LN_EPS))

    def forward(self, x, ss, rel_emb, key_mask):
        out = self.attention.output
        x = out.LayerNorm(x + out.dense(self.attention.self(x, ss, rel_emb, key_mask)))
        y = self.output.dense(F.gelu(self.intermediate.dense(x)))
        return self.output.LayerNorm(x + y)


class ProSST(nn.Module):
    """(B, T) residue and structure token grids -> (B, T, vocab) float32
    logits."""

    def __init__(self, c: ProSSTConfig):
        super().__init__()
        self.config = c
        d = c.hidden
        self.prosst = Named(
            embeddings=Named(word_embeddings=nn.Embedding(c.vocab_size, d),
                              ss_embeddings=nn.Embedding(c.ss_vocab_size, d),
                              LayerNorm=nn.LayerNorm(d, eps=LN_EPS)),
            encoder=Named(rel_embeddings=nn.Embedding(2 * c.max_relative_positions, d),
                           layer=nn.ModuleList(ProSSTLayer(c) for _ in range(c.num_layers))))
        self.cls = Named(predictions=Named(transform=_dense_ln(d),
                                             decoder=nn.Linear(d, c.vocab_size)))

    def forward(self, tokens, ss_tokens, key_mask=None):
        emb, enc = self.prosst.embeddings, self.prosst.encoder
        x = emb.LayerNorm(emb.word_embeddings(tokens))
        ss = emb.ss_embeddings(ss_tokens)
        for layer in enc.layer:
            x = layer(x, ss, enc.rel_embeddings.weight, key_mask)
        head = self.cls.predictions
        h = head.transform.LayerNorm(F.gelu(head.transform.dense(x)))
        return head.decoder(h)


def _empty(c: ProSSTConfig, device) -> ProSST:
    with torch.device("meta"):
        model = ProSST(c)
    return model.to_empty(device=resolve_device(device)).eval().requires_grad_(False)


@torch.no_grad()
def init_random(c: ProSSTConfig, seed: int = 0, device="cuda") -> ProSST:
    """Seeded random weights with the JAX ``prosst_init_params``
    distribution (the draws differ): every matrix and embedding
    N(0, 0.02^2), zero biases, unit layer-norm scales."""
    model = _empty(c, device)
    dev = model.cls.predictions.decoder.weight.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, p in model.named_parameters():
        if p.dim() == 2:
            p.copy_(torch.randn(tuple(p.shape), generator=gen, device=dev) * 0.02)
        elif "LayerNorm.weight" in name:
            p.fill_(1.0)
        else:
            p.zero_()
    return model


def _tensor(value) -> torch.Tensor:
    return value if torch.is_tensor(value) else torch.from_numpy(np.asarray(value, np.float32))


@torch.no_grad()
def load_hf_state_dict(sd: Mapping, c: ProSSTConfig, device="cuda") -> ProSST:
    """The model from an AI4Protein/ProSST HuggingFace state dict (tensors
    or numpy arrays), its keys found as the JAX converter finds them: the
    ``prosst.`` or ``deberta.`` prefix or none; split ``query_proj`` /
    ``query`` (and key, value) or DeBERTa v1's fused ``in_proj``, its rows
    packed per head as (q_h, k_h, v_h), with ``q_bias`` and ``v_bias``;
    ``pos_proj`` or ``pos_key_proj``, ``ss_proj`` or ``ss_key_proj``; the
    head under ``cls.predictions.`` or ``lm_head.``. A parameter found
    under none of its names raises; an absent bias is zero."""
    pre = next((p for p in ("prosst.", "deberta.") if any(k.startswith(p) for k in sd)), "")
    out: Dict[str, torch.Tensor] = {}

    def first(*cands):
        for k in cands:
            if k in sd:
                return k
        raise KeyError(f"none of {cands} in checkpoint")

    def lin(ours, *cands, bias=True):
        k = first(*cands)
        out[f"{ours}.weight"] = _tensor(sd[k])
        bk = k.replace(".weight", ".bias")
        if bias:
            out[f"{ours}.bias"] = _tensor(sd[bk]) if bk in sd else torch.zeros(
                out[f"{ours}.weight"].shape[0])

    def ln(ours, *cands):
        k = first(*cands)
        out[f"{ours}.weight"] = _tensor(sd[k])
        out[f"{ours}.bias"] = _tensor(sd[k.replace(".weight", ".bias")])

    e = "prosst.embeddings"
    out[f"{e}.word_embeddings.weight"] = _tensor(
        sd[first(f"{pre}embeddings.word_embeddings.weight")])
    out[f"{e}.ss_embeddings.weight"] = _tensor(
        sd[first(f"{pre}embeddings.ss_embeddings.weight")])
    ln(f"{e}.LayerNorm", f"{pre}embeddings.LayerNorm.weight")
    out["prosst.encoder.rel_embeddings.weight"] = _tensor(
        sd[first(f"{pre}encoder.rel_embeddings.weight")])
    d, hd = c.hidden, c.head_dim
    for i in range(c.num_layers):
        b, ours = f"{pre}encoder.layer.{i}", f"prosst.encoder.layer.{i}"
        a, oa = f"{b}.attention.self", f"{ours}.attention.self"
        if f"{a}.in_proj.weight" in sd:
            per_head = _tensor(sd[f"{a}.in_proj.weight"]).reshape(c.num_heads, 3, hd, d)
            for j, name in enumerate(("query_proj", "key_proj", "value_proj")):
                out[f"{oa}.{name}.weight"] = per_head[:, j].reshape(d, d)
            out[f"{oa}.query_proj.bias"] = _tensor(sd[f"{a}.q_bias"])
            out[f"{oa}.key_proj.bias"] = torch.zeros(d)
            out[f"{oa}.value_proj.bias"] = _tensor(sd[f"{a}.v_bias"])
        else:
            for name, alt in (("query_proj", "query"), ("key_proj", "key"),
                              ("value_proj", "value")):
                lin(f"{oa}.{name}", f"{a}.{name}.weight", f"{a}.{alt}.weight")
        lin(f"{oa}.pos_proj", f"{a}.pos_proj.weight", f"{a}.pos_key_proj.weight", bias=False)
        lin(f"{oa}.pos_q_proj", f"{a}.pos_q_proj.weight", f"{a}.pos_query_proj.weight")
        lin(f"{oa}.ss_proj", f"{a}.ss_proj.weight", f"{a}.ss_key_proj.weight", bias=False)
        lin(f"{oa}.ss_q_proj", f"{a}.ss_q_proj.weight", f"{a}.ss_query_proj.weight")
        lin(f"{ours}.attention.output.dense", f"{b}.attention.output.dense.weight")
        ln(f"{ours}.attention.output.LayerNorm", f"{b}.attention.output.LayerNorm.weight")
        lin(f"{ours}.intermediate.dense", f"{b}.intermediate.dense.weight")
        lin(f"{ours}.output.dense", f"{b}.output.dense.weight")
        ln(f"{ours}.output.LayerNorm", f"{b}.output.LayerNorm.weight")
    lin("cls.predictions.transform.dense", "cls.predictions.transform.dense.weight",
        "lm_head.dense.weight")
    ln("cls.predictions.transform.LayerNorm", "cls.predictions.transform.LayerNorm.weight",
       "lm_head.layer_norm.weight")
    lin("cls.predictions.decoder", "cls.predictions.decoder.weight", "lm_head.decoder.weight")
    return copy_state_dict(_empty(c, device), out, c.name)


def params_from_jax(params, c: ProSSTConfig) -> Dict[str, torch.Tensor]:
    """The JAX params pytree (numpy leaves) in the model's names: (in, out)
    matrices as (out, in), absent biases zero."""
    a = lambda x: torch.from_numpy(np.array(x, dtype=np.float32))  # noqa: E731
    sd: Dict[str, torch.Tensor] = {}

    def lin(ours, p, bias=True):
        sd[f"{ours}.weight"] = a(np.asarray(p["w"]).T)
        if bias:
            sd[f"{ours}.bias"] = a(p["b"]) if "b" in p else torch.zeros(np.shape(p["w"])[1])

    def ln(ours, p):
        sd[f"{ours}.weight"], sd[f"{ours}.bias"] = a(p["g"]), a(p["b"])

    sd["prosst.embeddings.word_embeddings.weight"] = a(params["word_embeddings"])
    sd["prosst.embeddings.ss_embeddings.weight"] = a(params["ss_embeddings"])
    ln("prosst.embeddings.LayerNorm", params["emb_ln"])
    sd["prosst.encoder.rel_embeddings.weight"] = a(params["rel_embeddings"])
    for i, layer in enumerate(params["layers"]):
        p = f"prosst.encoder.layer.{i}"
        for ours, key in (("query_proj", "q"), ("key_proj", "k"), ("value_proj", "v"),
                          ("pos_q_proj", "pos_query"), ("ss_q_proj", "ss_query")):
            lin(f"{p}.attention.self.{ours}", layer[key])
        lin(f"{p}.attention.self.pos_proj", layer["pos_key"], bias=False)
        lin(f"{p}.attention.self.ss_proj", layer["ss_key"], bias=False)
        lin(f"{p}.attention.output.dense", layer["attn_out"])
        ln(f"{p}.attention.output.LayerNorm", layer["attn_ln"])
        lin(f"{p}.intermediate.dense", layer["inter"])
        lin(f"{p}.output.dense", layer["out"])
        ln(f"{p}.output.LayerNorm", layer["out_ln"])
    lin("cls.predictions.transform.dense", params["mlm"]["dense"])
    ln("cls.predictions.transform.LayerNorm", params["mlm"]["ln"])
    lin("cls.predictions.decoder", params["mlm"]["decoder"])
    return sd


def state_shape(sd: Mapping):
    """(layers, width, structure vocabulary) of a HuggingFace ProSST state
    dict: every ``prosst_{K}`` preset has the same (layers, width), so the
    structure vocabulary's rows pick K."""
    pre = next((p for p in ("prosst.", "deberta.") if any(k.startswith(p) for k in sd)), "")
    n = 1 + max(int(k[len(f"{pre}encoder.layer."):].split(".", 1)[0]) for k in sd
                if k.startswith(f"{pre}encoder.layer."))
    word = np.shape(sd[f"{pre}embeddings.word_embeddings.weight"])
    ss = np.shape(sd[f"{pre}embeddings.ss_embeddings.weight"])
    return n, int(word[1]), int(ss[0])


def config_shape(c: ProSSTConfig):
    return c.num_layers, c.hidden, c.ss_vocab_size


def _wt_logp(model: ProSST, sequence: str, structure_tokens) -> np.ndarray:
    """One unmasked forward of the WT -> its residues' (L, vocab) float32
    log-probs on the host; a structure stream of another length raises."""
    dev = model.cls.predictions.decoder.weight.device
    tokens = tokenize_prosst(sequence)[None]
    ss = tokenize_structure_sequence(structure_tokens)[None]
    if tokens.shape != ss.shape:
        raise ValueError(f"structure token count {ss.shape[1] - 2} != sequence length "
                         f"{tokens.shape[1] - 2}")
    with torch.no_grad():
        logits = model(torch.as_tensor(tokens, device=dev), torch.as_tensor(ss, device=dev))
    return torch.log_softmax(logits[0, 1:-1], -1).cpu().numpy()


def _mutant_sums(logp: np.ndarray, sequence: str, mutants: Sequence[str],
                 offset_idx: int) -> np.ndarray:
    out = np.zeros(len(mutants))
    for i, m in enumerate(mutants):
        if is_wt_row(m):
            continue
        for tok in m.split(":"):
            wt, pos, mt = tok[0], int(tok[1:-1]) - offset_idx, tok[-1]
            if sequence[pos] != wt:
                raise ValueError(f"WT mismatch in {tok}")
            out[i] += logp[pos, PROSST_IDX[mt]] - logp[pos, PROSST_IDX[wt]]
    return out


def score_assay_prosst_real(model: ProSST, sequence: str, structure_tokens,
                            mutants: Sequence[str], offset_idx: int = 1) -> np.ndarray:
    """WT marginals over the residue stream with the structure stream fixed
    (ref compute_fitness.py:31-63): one forward, WT rows 0."""
    return _mutant_sums(_wt_logp(model, sequence, structure_tokens), sequence, mutants,
                        offset_idx)


def read_structure_sequence_fasta(path) -> np.ndarray:
    """ProSST's comma-separated integer token FASTA (ref compute_fitness.py:33-36)."""
    seq = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith(">"):
                seq.extend(int(t) for t in line.split(","))
    return np.asarray(seq, np.int32)


# ---------------------------------------------------------------------------
# VenusREM: ProSST-2048's log-probs blended with alignment column counts
# ---------------------------------------------------------------------------


def read_alignment_fasta(path):
    """(headers, sequences) of a FASTA, sequences joined over lines
    (venusrem/compute_fitness.py:39-60; every row is kept as read)."""
    headers, seqs, cur, header = [], [], "", None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if cur:
                    headers.append(header)
                    seqs.append(cur)
                    cur = ""
                header = line
            elif line:
                cur += line
    if cur:
        headers.append(header)
        seqs.append(cur)
    return headers, seqs


def alignment_count_log_softmax(seqs, vocab_size: int = 25) -> np.ndarray:
    """(L, vocab) log-softmax of each column's token distribution: '-' and
    '.' (and the ragged tails) count as [PAD]. The reference applies the
    log-softmax to the probabilities, not to their logs; kept."""
    L = max(len(s) for s in seqs)
    counts = np.zeros((L, vocab_size), np.float64)
    for s in seqs:
        s = s.upper()
        for i, ch in enumerate(s):
            if ch in ("-", "."):
                counts[i, P_PAD] += 1
            else:
                counts[i, PROSST_IDX.get(ch, P_UNK)] += 1
        for i in range(len(s), L):
            counts[i, P_PAD] += 1
    probs = counts / np.maximum(counts.sum(1, keepdims=True), 1)
    z = probs - probs.max(1, keepdims=True)
    return z - np.log(np.exp(z).sum(1, keepdims=True))


def parse_alignment_range(header: str, aln_len: int):
    """'>name/start-end' -> the 0-based [start - 1, end); otherwise [0, aln_len)."""
    try:
        start, end = header.split("/")[-1].split("-")
        return int(start) - 1, int(end)
    except Exception:
        return 0, aln_len


def venusrem_score_assay_real(model: ProSST, sequence: str, structure_tokens,
                              mutants: Sequence[str], aa_alignment=None, struct_alignment=None,
                              alpha: float = 0.8, offset_idx: int = 1) -> np.ndarray:
    """ProSST's WT log-probs, each blended (1 - alpha) logp + alpha * the
    alignment's column log-softmax: the structure alignment from residue 0,
    the residue alignment over its header's range
    (venusrem/compute_fitness.py:127-226)."""
    logp = _wt_logp(model, sequence, structure_tokens)
    vocab = model.config.vocab_size
    if struct_alignment and struct_alignment[1]:
        cm = alignment_count_log_softmax(struct_alignment[1], vocab)
        n = min(len(cm), len(logp))
        logp[:n] = (1 - alpha) * logp[:n] + alpha * cm[:n]
    if aa_alignment and aa_alignment[1]:
        headers, seqs = aa_alignment
        cm = alignment_count_log_softmax(seqs, vocab)
        start, end = parse_alignment_range(headers[0], len(cm))
        end = min(end, len(logp), start + len(cm))
        logp[start:end] = (1 - alpha) * logp[start:end] + alpha * cm[:end - start]
    return _mutant_sums(logp, sequence, mutants, offset_idx)
