"""ProteinMPNN as PyTorch modules (counterpart of
proteingym_tpu/models/protein_mpnn.py; ref
proteingym/baselines/protein_mpnn/protein_mpnn_utils.py):

- features (:921-1020): the kNN graph on CA distances, 25 backbone
  atom-pair RBFs (N, CA, C, O and the virtual CB; 16 bins on [2, 22] A)
  and the relative-position one-hot (clipped at +-32, 66 classes) ->
  linear (no bias) -> LayerNorm; node features start at zero;
- the encoder (:618-668, 3 layers, hidden 128): messages MLP([h_V_i, h_E,
  h_V_j]) summed over the K neighbours / 30, residual + LN, feed-forward,
  then the edge update;
- the decoder (:672-716, 3 layers), teacher-forced along a decoding
  order: position i sees the sequence embeddings of the neighbours decoded
  before it and the encoder's features of the others (:1080-1098);
- scoring: the mean NLL of each sequence, averaged over random decoding
  orders (compute_fitness.py:187-230), returned as -NLL.

float32, exact-erf GELU. The encoder is sequence-independent and runs once
per structure; the decoder runs (sequence, order) pairs batched, in chunks
that keep the per-pair (L, K, 4 x hidden) message inputs within
``PAIR_BYTES_BUDGET``. The kNN takes neighbours by a stable ascending sort
(ties to the lower index, as ``jax.lax.top_k``) of distances summed one
coordinate at a time. Parameter names are the reference's, so the
published ``v_48_020.pt`` (``{"model_state_dict": ...}``) loads by name.
Alphabet: 'ACDEFGHIKLMNPQRSTVWYX' (ref :20).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from proteingym_tpu_torch.devices import resolve_device
from proteingym_tpu_torch.models.state_dict import copy_state_dict
from proteingym_tpu_torch.models.gvp_transformer import _sq3

MPNN_ALPHABET = "ACDEFGHIKLMNPQRSTVWYX"

# the device bytes a decoder chunk's (pairs, L, K, hidden) float32
# activations may take: PAIR_TENSORS such tensors live at the peak of a
# layer (the persistent [h_E, h_S_j] and encoder-side inputs, 5 wide; the
# layer's 3-wide mix, its 4-wide message input, and the MLP's hidden
# tensors), so a chunk holds budget / (PAIR_TENSORS x L x K x hidden x 4)
# pairs
PAIR_BYTES_BUDGET = 4 * 2**30
PAIR_TENSORS = 16


@dataclasses.dataclass(frozen=True)
class MpnnConfig:
    name: str = "v_48_020"
    hidden_dim: int = 128
    edge_features: int = 128
    num_encoder_layers: int = 3
    num_decoder_layers: int = 3
    k_neighbors: int = 48
    num_rbf: int = 16
    num_positional_embeddings: int = 16
    max_relative_feature: int = 32
    vocab: int = 21
    scale: float = 30.0  # the message-sum divisor (ref :627)


PRESETS = {"v_48_020": MpnnConfig()}


def tokenize_sequence(seq: str) -> np.ndarray:
    idx = {a: i for i, a in enumerate(MPNN_ALPHABET)}
    return np.asarray([idx.get(c, idx["X"]) for c in seq], dtype=np.int64)


# ---------------------------------------------------------------------------
# modules (parameter names of the reference)

class PositionalEncodings(nn.Module):
    def __init__(self, c: MpnnConfig, device=None):
        super().__init__()
        self.linear = nn.Linear(2 * c.max_relative_feature + 2, c.num_positional_embeddings,
                                device=device)


class ProteinFeatures(nn.Module):
    def __init__(self, c: MpnnConfig, device=None):
        super().__init__()
        self.embeddings = PositionalEncodings(c, device)
        self.edge_embedding = nn.Linear(c.num_positional_embeddings + 25 * c.num_rbf,
                                        c.edge_features, bias=False, device=device)
        self.norm_edges = nn.LayerNorm(c.edge_features, device=device)


class PositionWiseFeedForward(nn.Module):
    def __init__(self, h, device=None):
        super().__init__()
        self.W_in = nn.Linear(h, 4 * h, device=device)
        self.W_out = nn.Linear(4 * h, h, device=device)

    def forward(self, x):
        return self.W_out(F.gelu(self.W_in(x)))


class EncLayer(nn.Module):
    def __init__(self, h, device=None):
        super().__init__()
        for name, n_in in (("W1", 3 * h), ("W2", h), ("W3", h), ("W11", 3 * h), ("W12", h),
                           ("W13", h)):
            setattr(self, name, nn.Linear(n_in, h, device=device))
        for name in ("norm1", "norm2", "norm3"):
            setattr(self, name, nn.LayerNorm(h, device=device))
        self.dense = PositionWiseFeedForward(h, device)


class DecLayer(nn.Module):
    def __init__(self, h, device=None):
        super().__init__()
        self.W1 = nn.Linear(4 * h, h, device=device)
        self.W2 = nn.Linear(h, h, device=device)
        self.W3 = nn.Linear(h, h, device=device)
        self.norm1 = nn.LayerNorm(h, device=device)
        self.norm2 = nn.LayerNorm(h, device=device)
        self.dense = PositionWiseFeedForward(h, device)


class ProteinMPNN(nn.Module):
    def __init__(self, config: MpnnConfig, device=None):
        super().__init__()
        self.config = config
        h = config.hidden_dim
        self.features = ProteinFeatures(config, device)
        self.W_e = nn.Linear(config.edge_features, h, device=device)
        self.W_s = nn.Embedding(config.vocab, h, device=device)
        self.encoder_layers = nn.ModuleList(EncLayer(h, device)
                                            for _ in range(config.num_encoder_layers))
        self.decoder_layers = nn.ModuleList(DecLayer(h, device)
                                            for _ in range(config.num_decoder_layers))
        self.W_out = nn.Linear(h, config.vocab, device=device)


def _mlp(x, w1, w2, w3):
    return w3(F.gelu(w2(F.gelu(w1(x)))))


# ---------------------------------------------------------------------------
# features, encoder, decoder

def virtual_cb(coords: torch.Tensor) -> torch.Tensor:
    """The idealised CB from backbone N, CA, C (ref :967-971)."""
    n, ca, cc = coords[:, 0], coords[:, 1], coords[:, 2]
    b, c = ca - n, cc - ca
    a = torch.linalg.cross(b, c, dim=-1)
    return -0.58273431 * a + 0.56802827 * b - 0.54067466 * c + ca


def _rbf(d, num_rbf):
    mu = torch.linspace(2.0, 22.0, num_rbf, device=d.device)
    sigma = (22.0 - 2.0) / num_rbf
    return torch.exp(-(((d[..., None] - mu) / sigma) ** 2))


# the atom pairs of the RBF features, in the reference's order (:979-1004)
ATOM_PAIRS = (
    ("Ca", "Ca"), ("N", "N"), ("C", "C"), ("O", "O"), ("Cb", "Cb"),
    ("Ca", "N"), ("Ca", "C"), ("Ca", "O"), ("Ca", "Cb"), ("N", "C"),
    ("N", "O"), ("N", "Cb"), ("Cb", "C"), ("Cb", "O"), ("O", "C"),
    ("N", "Ca"), ("C", "Ca"), ("O", "Ca"), ("Cb", "Ca"), ("C", "N"),
    ("O", "N"), ("Cb", "N"), ("C", "Cb"), ("O", "Cb"), ("C", "O"),
)


def neighbours(ca: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each residue's ``k`` nearest residues by CA distance (itself first),
    in ascending distance, ties to the lower index: (distances, indices),
    both (L, k)."""
    d = torch.sqrt(_sq3(ca[:, None] - ca[None]) + 1e-6)
    d_nb, e_idx = torch.sort(d, dim=-1, stable=True)
    return d_nb[:, :k], e_idx[:, :k]


def featurize(model: ProteinMPNN, coords: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """coords (L, 4, 3) N/CA/C/O -> (E (L, K, edge_features), E_idx (L, K))."""
    c = model.config
    n = coords.shape[0]
    d_nb, e_idx = neighbours(coords[:, 1], min(c.k_neighbors, n))
    atoms = {"N": coords[:, 0], "Ca": coords[:, 1], "C": coords[:, 2], "O": coords[:, 3],
             "Cb": virtual_cb(coords)}
    rbfs = [_rbf(d_nb, c.num_rbf)]
    for a, b in ATOM_PAIRS[1:]:
        d_ab = torch.sqrt(_sq3(atoms[a][:, None] - atoms[b][e_idx]) + 1e-6)
        rbfs.append(_rbf(d_ab, c.num_rbf))
    m = c.max_relative_feature
    offset = torch.arange(n, device=coords.device)[:, None] - e_idx
    onehot = F.one_hot(torch.clamp(offset + m, 0, 2 * m), 2 * m + 2).to(coords.dtype)
    e = torch.cat([model.features.embeddings.linear(onehot)] + rbfs, -1)
    return model.features.norm_edges(model.features.edge_embedding(e)), e_idx


def _slots(h_v, h_e, e_idx):
    """[h_V_i, h_E, h_V_j]: the reference's cat_neighbors_nodes layout."""
    return torch.cat([h_v[:, None].expand(-1, e_idx.shape[1], -1), h_e, h_v[e_idx]], -1)


@torch.no_grad()
def encode(model: ProteinMPNN, coords: torch.Tensor):
    """The sequence-independent graph encoding: (h_V, h_E, E_idx)."""
    c = model.config
    e, e_idx = featurize(model, coords)
    h_v = e.new_zeros((e.shape[0], c.hidden_dim))
    h_e = model.W_e(e)
    for layer in model.encoder_layers:
        msg = _mlp(_slots(h_v, h_e, e_idx), layer.W1, layer.W2, layer.W3)
        h_v = layer.norm1(h_v + msg.sum(-2) / c.scale)
        h_v = layer.norm2(h_v + layer.dense(h_v))
        h_e = layer.norm3(h_e + _mlp(_slots(h_v, h_e, e_idx), layer.W11, layer.W12, layer.W13))
    return h_v, h_e, e_idx


@torch.no_grad()
def decode(model: ProteinMPNN, enc, tokens: torch.Tensor, orders: torch.Tensor) -> torch.Tensor:
    """Teacher-forced conditional log-probs (P, L, vocab) of P (sequence,
    decoding order) pairs: ``tokens`` and ``orders`` (P, L), each order a
    permutation of range(L)."""
    c = model.config
    h_v, h_e, e_idx = enc
    p, n = tokens.shape
    k = e_idx.shape[1]
    # rank[i] = the step that decodes i; i sees j's sequence iff rank[j] < rank[i]
    steps = torch.arange(n, device=tokens.device).expand(p, n)
    rank = torch.empty_like(orders).scatter_(1, orders, steps)
    attend = (rank[:, e_idx] < rank[:, :, None])[..., None].to(h_v.dtype)  # (P, L, K, 1)
    h_e = h_e.expand(p, -1, -1, -1)
    # [h_E, h_S_j]; the encoder side [h_E, 0, h_V_j] where j is not yet decoded
    h_es = torch.cat([h_e, model.W_s(tokens)[:, e_idx]], -1)
    h_exv_fw = (1.0 - attend) * torch.cat([h_e, torch.zeros_like(h_e), h_v[e_idx].expand(
        p, -1, -1, -1)], -1)
    h_v = h_v.expand(p, -1, -1)
    for layer in model.decoder_layers:
        h_esv = attend * torch.cat([h_es, h_v[:, e_idx]], -1) + h_exv_fw
        h_in = torch.cat([h_v[:, :, None].expand(-1, -1, k, -1), h_esv], -1)
        del h_esv
        msg = _mlp(h_in, layer.W1, layer.W2, layer.W3)
        del h_in
        h_v = layer.norm1(h_v + msg.sum(-2) / c.scale)
        h_v = layer.norm2(h_v + layer.dense(h_v))
    return torch.log_softmax(model.W_out(h_v), -1)


def decoding_orders(length: int, n_orders: int, seed: int = 37) -> np.ndarray:
    """The reference's random decoding orders, argsort |randn| (the chain
    fully decodable), drawn as the JAX scorer draws them:
    ``np.random.default_rng(seed)``, one order after another."""
    rng = np.random.default_rng(seed)
    return np.stack([np.argsort(np.abs(rng.standard_normal(length)))
                     for _ in range(n_orders)]).astype(np.int64)


def pairs_per_chunk(model: ProteinMPNN, length: int, k: int) -> int:
    """The (sequence, order) pairs one decoder chunk takes: as many as keep
    PAIR_TENSORS (pairs, L, K, hidden) float32 tensors within
    PAIR_BYTES_BUDGET, at least one."""
    per_pair = PAIR_TENSORS * length * k * model.config.hidden_dim * 4
    return max(1, PAIR_BYTES_BUDGET // per_pair)


def score_sequences(model: ProteinMPNN, coords: np.ndarray, sequences: Sequence[str],
                    n_orders: int = 10, seed: int = 37, max_pairs: int = None) -> np.ndarray:
    """Each sequence's -NLL, its mean NLL averaged over ``n_orders`` random
    decoding orders (compute_fitness.py:207-230; higher is more likely).
    The encoder runs once; the sequence x order pairs run in chunks of
    ``max_pairs`` (default ``pairs_per_chunk``), which changes no score."""
    dev = next(model.parameters()).device
    coords_t = torch.as_tensor(np.asarray(coords, np.float32), device=dev)
    n = coords_t.shape[0]
    lengths = {len(s) for s in sequences}
    if lengths - {n}:
        raise ValueError(f"protein_mpnn scores sequences of the structure's length {n}; got "
                         f"lengths {sorted(lengths)}")
    enc = encode(model, coords_t)
    orders = torch.as_tensor(decoding_orders(n, n_orders, seed), device=dev)
    toks = torch.as_tensor(np.stack([tokenize_sequence(s) for s in sequences]), device=dev)
    seq_of = torch.arange(len(sequences), device=dev).repeat_interleave(n_orders)
    order_of = torch.arange(n_orders, device=dev).repeat(len(sequences))
    chunk = max_pairs or pairs_per_chunk(model, n, enc[2].shape[1])
    nll = []
    for s0 in range(0, len(seq_of), chunk):
        tok = toks[seq_of[s0:s0 + chunk]]
        logp = decode(model, enc, tok, orders[order_of[s0:s0 + chunk]])
        nll.append(-logp.gather(-1, tok[..., None])[..., 0].mean(-1))
    per_seq = torch.cat(nll).view(len(sequences), n_orders).mean(-1)
    return -per_seq.double().cpu().numpy()


# ---------------------------------------------------------------------------
# weights

def _empty_model(config: MpnnConfig, device) -> ProteinMPNN:
    with torch.device("meta"):
        model = ProteinMPNN(config)
    return model.to_empty(device=resolve_device(device)).eval().requires_grad_(False)


@torch.no_grad()
def init_random(config: MpnnConfig, seed: int = 0, device="cuda") -> ProteinMPNN:
    """Seeded random weights with the JAX ``init_params`` distributions (the
    draws differ): Glorot-uniform dense weights, zero biases, unit
    LayerNorm scales, ``W_s`` N(0, 0.02^2)."""
    model = _empty_model(config, device)
    dev = model.W_e.weight.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for module in model.modules():
        if isinstance(module, nn.Linear):
            n_out, n_in = module.weight.shape
            lim = float(np.sqrt(6.0 / (n_in + n_out)))
            module.weight.copy_((torch.rand((n_out, n_in), generator=gen, device=dev) * 2 - 1)
                                * lim)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    model.W_s.weight.copy_(torch.randn(tuple(model.W_s.weight.shape), generator=gen,
                                       device=dev) * 0.02)
    return model


def load_state_dict(state_dict: Mapping, config: MpnnConfig, device="cuda") -> ProteinMPNN:
    """The model from the reference's state dict (the ``model_state_dict``
    entry of ``v_48_020.pt``); entries it does not hold are ignored, a
    missing one raises."""
    return copy_state_dict(_empty_model(config, device), state_dict, config.name)


def params_from_jax(params, config: MpnnConfig) -> Dict[str, torch.Tensor]:
    """The JAX params pytree (numpy leaves) as a reference-named state dict."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key, value):
        sd[key] = torch.from_numpy(np.array(value, dtype=np.float32))

    def dense(prefix, p):
        put(f"{prefix}.weight", np.asarray(p["w"]).T)
        if "b" in p:
            put(f"{prefix}.bias", p["b"])

    def ln(prefix, p):
        put(f"{prefix}.weight", p["g"])
        put(f"{prefix}.bias", p["b"])

    dense("features.embeddings.linear", params["pos_linear"])
    dense("features.edge_embedding", params["edge_embedding"])
    ln("features.norm_edges", params["norm_edges"])
    dense("W_e", params["W_e"])
    put("W_s.weight", params["W_s"])
    dense("W_out", params["W_out"])
    for side, layers in (("encoder_layers", params["encoder"]),
                         ("decoder_layers", params["decoder"])):
        for i, layer in enumerate(layers):
            for name, p in layer.items():
                prefix = f"{side}.{i}." + {"ffn_in": "dense.W_in",
                                           "ffn_out": "dense.W_out"}.get(name, name)
                (ln if name.startswith("norm") else dense)(prefix, p)
    return sd
