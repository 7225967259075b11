"""WaveNet (SeqDesign), the causal dilated-convolution family model
(counterpart of proteingym_tpu/models/wavenet.py).

A residual causal CNN trained per family on the assay's MSA rows, which
scores a variant by its autoregressive log-likelihood, so insertions and
deletions need no alignment (ref Shin et al. 2021). The shape is the JAX
package's: an embedding, ``num_layers`` residual blocks of [layer norm ->
GELU -> 1x1 down -> layer norm -> GELU -> causal dilated convolution (k=2)
-> layer norm -> GELU -> 1x1 up], dilations cycling 1, 2, 4, ...,
``max_dilation``, a final layer norm and a vocabulary head. Every sequence
starts with the BOS token.

As in the JAX package: the GELU is the tanh approximation (``jax.nn.gelu``'s
default), the layer norms use the population variance, the convolution is
a cross-correlation left-padded by ``dilation * (k - 1)``. Torch keeps a
convolution weight as (out, in, k) where JAX keeps (k, in, out), and a
dense weight as (out, in) where JAX keeps (in, out); ``params_from_jax``
converts. Everything is float32: training and scoring run their
products and convolutions without TF32 (``devices.no_tf32``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from proteingym_tpu_torch.devices import adam, no_tf32, resolve_device, seeded_generator
from proteingym_tpu_torch.models.state_dict import copy_state_dict

WAVENET_ALPHABET = "*ACDEFGHIKLMNPQRSTVWYX"  # 0 = BOS/pad
BOS = 0


def encode(seq: str) -> np.ndarray:
    """int32 tokens: BOS, then one per letter, a letter outside the
    alphabet as ``X``."""
    idx = {a: i for i, a in enumerate(WAVENET_ALPHABET)}
    return np.asarray([BOS] + [idx.get(c, idx["X"]) for c in seq], np.int32)


@dataclasses.dataclass(frozen=True)
class WavenetConfig:
    name: str = "wavenet"
    vocab: int = len(WAVENET_ALPHABET)
    embed_dim: int = 48
    hidden_dim: int = 48
    kernel_size: int = 2
    num_layers: int = 12
    max_dilation: int = 32
    steps: int = 400
    learning_rate: float = 1e-3
    batch: int = 32


def _dilations(c: WavenetConfig) -> List[int]:
    out, d = [], 1
    for _ in range(c.num_layers):
        out.append(d)
        d *= 2
        if d > c.max_dilation:
            d = 1
    return out


def _gelu(x):
    return F.gelu(x, approximate="tanh")


class Block(nn.Module):
    def __init__(self, c: WavenetConfig, dilation: int, device=None):
        super().__init__()
        d, h = c.embed_dim, c.hidden_dim
        self.ln1 = nn.LayerNorm(d, device=device)
        self.down = nn.Linear(d, h, device=device)
        self.ln2 = nn.LayerNorm(h, device=device)
        self.conv = nn.Conv1d(h, h, c.kernel_size, dilation=dilation, device=device)
        self.ln3 = nn.LayerNorm(h, device=device)
        self.up = nn.Linear(h, d, device=device)
        self.pad = dilation * (c.kernel_size - 1)

    def forward(self, x):
        y = _gelu(self.ln2(self.down(_gelu(self.ln1(x))))).transpose(1, 2)  # (B, H, T)
        y = self.conv(F.pad(y, (self.pad, 0))).transpose(1, 2)
        return x + self.up(_gelu(self.ln3(y)))


class Wavenet(nn.Module):
    def __init__(self, config: WavenetConfig, device=None):
        super().__init__()
        self.config = config
        self.embed = nn.Embedding(config.vocab, config.embed_dim, device=device)
        self.layers = nn.ModuleList(Block(config, dil, device) for dil in _dilations(config))
        self.final_ln = nn.LayerNorm(config.embed_dim, device=device)
        self.head = nn.Linear(config.embed_dim, config.vocab, device=device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, T) tokens -> (B, T, V) next-token logits (causal)."""
        x = self.embed(tokens)
        for layer in self.layers:
            x = layer(x)
        return self.head(self.final_ln(x))


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def _empty_model(config: WavenetConfig, device) -> Wavenet:
    with torch.device("meta"):
        model = Wavenet(config)
    return model.to_empty(device=resolve_device(device)).eval().requires_grad_(False)


@torch.no_grad()
def init_random(config: WavenetConfig, seed: int = 0, device="cuda") -> Wavenet:
    """Seeded random init with the JAX ``init_params`` distribution (the
    draws differ): the embedding N(0, 0.05^2), dense weights N(0, 1/n_in),
    convolution weights N(0, 1/(k * hidden)), biases 0, layer norms 1 and
    0."""
    model = _empty_model(config, device)
    dev = model.head.weight.device
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(p, std):
        p.copy_(torch.randn(tuple(p.shape), generator=gen, device=dev) * std)

    normal(model.embed.weight, 0.05)
    for module in model.modules():
        if isinstance(module, nn.Linear):
            normal(module.weight, float(np.sqrt(1.0 / module.in_features)))
            module.bias.zero_()
        elif isinstance(module, nn.Conv1d):
            normal(module.weight, float(np.sqrt(1.0 / (config.kernel_size * config.hidden_dim))))
            module.bias.zero_()
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    return model


def load_state_dict(state_dict: Mapping, config: WavenetConfig, device="cuda") -> Wavenet:
    return copy_state_dict(_empty_model(config, device), state_dict, "WaveNet")


def params_from_jax(params, config: WavenetConfig) -> Dict[str, torch.Tensor]:
    """The JAX params pytree (numpy leaves) as the port's state dict:
    dense weights (in, out) -> (out, in), convolution weights (k, in, out)
    -> (out, in, k)."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key, value):
        sd[key] = torch.from_numpy(np.array(value, dtype=np.float32))

    def ln(prefix, p):
        put(f"{prefix}.weight", p["g"])
        put(f"{prefix}.bias", p["b"])

    def lin(prefix, p):
        put(f"{prefix}.weight", np.asarray(p["w"]).T)
        put(f"{prefix}.bias", p["b"])

    put("embed.weight", params["embed"])
    for i, layer in enumerate(params["layers"]):
        for name in ("ln1", "ln2", "ln3"):
            ln(f"layers.{i}.{name}", layer[name])
        lin(f"layers.{i}.down", layer["down"])
        lin(f"layers.{i}.up", layer["up"])
        put(f"layers.{i}.conv.weight", np.transpose(np.asarray(layer["conv"]["w"]), (2, 1, 0)))
        put(f"layers.{i}.conv.bias", layer["conv"]["b"])
    ln("final_ln", params["final_ln"])
    lin("head", params["head"])
    return sd


# ---------------------------------------------------------------------------
# Training and scoring
# ---------------------------------------------------------------------------

def training_rows(sequences: Sequence[str], weights: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The rows the trainer draws from, as the JAX ``train`` makes them:
    each sequence upper-cased without ``-`` and ``.``, encoded, and kept
    when it has more than 2 tokens. Returns (N, T) int64 tokens padded
    with BOS, the (N, T) float32 mask of the targets (tokens 1..len-1),
    and each kept row's draw probability (its weight over their sum)."""
    encoded = [encode(s.upper().replace("-", "").replace(".", "")) for s in sequences]
    keep = [i for i, r in enumerate(encoded) if len(r) > 2]
    width = max(len(encoded[i]) for i in keep)
    tokens = np.zeros((len(keep), width), np.int64)
    mask = np.zeros((len(keep), width), np.float32)
    for j, i in enumerate(keep):
        tokens[j, :len(encoded[i])] = encoded[i]
        mask[j, 1:len(encoded[i])] = 1.0
    w = np.ones(len(keep)) if weights is None else np.asarray(weights, np.float64)[keep]
    return tokens, mask, w / w.sum()


def _token_log_likelihoods(model: Wavenet, tokens: torch.Tensor) -> torch.Tensor:
    """(B, T - 1) log-probabilities of tokens 1.. given the ones before."""
    logq = torch.log_softmax(model(tokens)[:, :-1], dim=-1)
    return logq.gather(-1, tokens[:, 1:, None])[..., 0]


def loss_fn(model: Wavenet, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The mean negative log-likelihood of the masked targets."""
    m = mask[:, 1:]
    return -(_token_log_likelihoods(model, tokens) * m).sum() / m.sum().clamp(min=1.0)


def train_step(model: Wavenet, optimizer: torch.optim.Optimizer, tokens: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """One Adam step on a batch, without TF32; returns the loss before the
    update, on the device."""
    optimizer.zero_grad(set_to_none=True)
    with no_tf32():
        loss = loss_fn(model, tokens, mask)
        loss.backward()
    optimizer.step()
    return loss.detach()


def train(model: Wavenet, config: WavenetConfig, sequences: Sequence[str],
          weights: Optional[np.ndarray] = None, seed: int = 0) -> Tuple[Wavenet, np.ndarray]:
    """Weighted autoregressive training on the family's sequences, in
    place on the model's device: ``config.steps`` Adam steps of rate
    ``config.learning_rate``, each on ``min(config.batch, N)`` rows of
    ``training_rows`` drawn with replacement by weight from stream 1 of
    ``seed`` (``seeded_generator``), so that they replay no
    ``init_random(seed=seed)``. Returns the model (in inference mode,
    without gradients) and the loss before each step."""
    dev = model.head.weight.device
    tokens, mask, probs = (torch.as_tensor(a, device=dev) for a in training_rows(sequences, weights))
    probs = probs.float()
    batch = min(config.batch, len(tokens))
    gen = seeded_generator(seed, dev, stream=1)
    model.requires_grad_(True)
    optimizer = adam(model, config.learning_rate)
    losses = torch.empty(config.steps, device=dev)
    for step in range(config.steps):
        idx = torch.multinomial(probs, batch, replacement=True, generator=gen)
        losses[step] = train_step(model, optimizer, tokens[idx], mask[idx])
    return model.requires_grad_(False), losses.cpu().numpy()


@torch.no_grad()
def score_sequences(model: Wavenet, sequences: Sequence[str], batch: int = 32) -> np.ndarray:
    """The summed autoregressive log-likelihood of each sequence, encoded
    as it is (no gap stripping, no upper-casing), in batches of ``batch``
    rows padded to the longest sequence; float64 (N,) of float32 sums."""
    dev = model.head.weight.device
    rows = [encode(s) for s in sequences]
    width = max(len(r) for r in rows)
    out = []
    with no_tf32():
        for start in range(0, len(rows), batch):
            block = rows[start:start + batch]
            tokens = np.zeros((len(block), width), np.int64)
            mask = np.zeros((len(block), width), np.float32)
            for i, r in enumerate(block):
                tokens[i, :len(r)] = r
                mask[i, 1:len(r)] = 1.0
            ll = _token_log_likelihoods(model, torch.from_numpy(tokens).to(dev))
            out.append((ll * torch.from_numpy(mask[:, 1:]).to(dev)).sum(dim=-1))
    return torch.cat(out).cpu().numpy().astype(np.float64)
