"""UniRep: the 1,900-unit mLSTM autoregressive protein LM, as a PyTorch
module (counterpart of proteingym_tpu/models/unirep.py; ref
proteingym/baselines/unirep/unirep.py mLSTMCell1900, unirep_inference.py):

  m_t = (x_t Wmx) * (h_{t-1} Wmh)          the multiplicative pathway
  z_t = x_t Wx + m_t Wh + b                4H gates: i, f, o, u
  c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(u)
  h_t = sigmoid(o) * tanh(c_t)

in float32, as a Python loop over T (the JAX ``lax.scan``); x_t Wmx and
x_t Wx do not depend on h, so they are taken for all T in one product
each. The logits of step t predict token t + 1. Scoring is the harness's
summed log-likelihood (``models/ar_scoring.batched_ar_loglik``).

Vocabulary (ref unirep data utils): 26 ids, pad 0, the original
aa_to_int table, start 24, stop 25. The parameters carry the names of the
published numpy weight files (``rnn_mlstm_mlstm_wx``, ...), which
``convert_tf_weights`` reads. ``evotune`` is the per-family finetuning (ref
unirep_evotune.py): weighted sampling of the alignment's rows and Adam on
the mean next-token loss.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from proteingym_tpu_torch.devices import adam, resolve_device, seeded_generator

# the original aa_to_int table (ref unirep/data_utils.py): pad 0, then the
# letters, X 23, start 24, stop 25
UNIREP_AA_TO_INT = {
    "M": 1, "R": 2, "H": 3, "K": 4, "D": 5, "E": 6, "S": 7, "T": 8, "N": 9,
    "Q": 10, "C": 11, "U": 12, "G": 13, "P": 14, "A": 15, "V": 16, "I": 17,
    "F": 18, "Y": 19, "W": 20, "L": 21, "O": 22, "X": 23,
}
UNIREP_START, UNIREP_STOP, UNIREP_PAD = 24, 25, 0


class UniRepTokenizer:
    PAD = UNIREP_PAD

    def encode(self, seq: str) -> np.ndarray:
        ids = [UNIREP_START] + [UNIREP_AA_TO_INT.get(c.upper(), 23) for c in seq] + [UNIREP_STOP]
        return np.asarray(ids, dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class UniRepConfig:
    name: str = "unirep_1900"
    embed_dim: int = 10
    hidden_dim: int = 1900
    vocab_size: int = 26


# parameter name (the published file's stem) -> shape
def _shapes(c: UniRepConfig) -> Dict[str, tuple]:
    e, h, v = c.embed_dim, c.hidden_dim, c.vocab_size
    return {"embed_matrix": (v, e), "rnn_mlstm_mlstm_wx": (e, 4 * h),
            "rnn_mlstm_mlstm_wh": (h, 4 * h), "rnn_mlstm_mlstm_wmx": (e, h),
            "rnn_mlstm_mlstm_wmh": (h, h), "rnn_mlstm_mlstm_b": (4 * h,),
            "fully_connected_weights": (h, v), "fully_connected_biases": (v,)}


class UniRep(nn.Module):
    """(B, T) tokens -> (B, T, V) float32 next-token logits."""

    def __init__(self, config: UniRepConfig):
        super().__init__()
        self.config = config
        for name, shape in _shapes(config).items():
            self.register_parameter(name, nn.Parameter(torch.empty(shape)))

    def forward(self, tokens):
        x = self.embed_matrix[tokens]  # (B, T, E)
        xmx = x @ self.rnn_mlstm_mlstm_wmx  # (B, T, H)
        xx = x @ self.rnn_mlstm_mlstm_wx  # (B, T, 4H)
        h = torch.zeros(tokens.shape[0], self.config.hidden_dim, device=tokens.device)
        c = torch.zeros_like(h)
        hs = []
        for t in range(tokens.shape[1]):
            m = xmx[:, t] * (h @ self.rnn_mlstm_mlstm_wmh)
            z = xx[:, t] + m @ self.rnn_mlstm_mlstm_wh + self.rnn_mlstm_mlstm_b
            i, f, o, u = z.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(u)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        return torch.stack(hs, dim=1) @ self.fully_connected_weights + self.fully_connected_biases


def _empty(config: UniRepConfig, device) -> UniRep:
    with torch.device("meta"):
        model = UniRep(config)
    return model.to_empty(device=resolve_device(device)).eval().requires_grad_(False)


@torch.no_grad()
def init_params(config: UniRepConfig, seed: int = 0, device="cuda") -> UniRep:
    """Seeded random weights with the JAX ``init_params`` distribution (the
    draws differ): matrices N(0, 0.05^2), zero biases."""
    model = _empty(config, device)
    gen = seeded_generator(seed, model.embed_matrix.device)
    for name, p in model.named_parameters():
        if p.dim() == 1:
            p.zero_()
        else:
            p.copy_(torch.randn(tuple(p.shape), generator=gen, device=p.device) * 0.05)
    return model


def load_state_dict(arrays, config: UniRepConfig, device="cuda") -> UniRep:
    """The model from {published name: array}."""
    model = _empty(config, device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            value = np.array(arrays[name], dtype=np.float32)
            if value.shape != tuple(p.shape):
                raise ValueError(f"{name}: file shape {value.shape}, model shape {tuple(p.shape)}")
            p.copy_(torch.from_numpy(value))
    return model


def convert_tf_weights(weight_dir, config: UniRepConfig, device="cuda") -> UniRep:
    """The model from the published numpy weight files, ``<name>:0.npy`` or
    ``<name>.npy`` in ``weight_dir`` (ref unirep_inference.py)."""
    d = Path(weight_dir)

    def load(name):
        for cand in (d / f"{name}:0.npy", d / f"{name}.npy"):
            if cand.exists():
                return np.load(cand)
        raise FileNotFoundError(f"no {name} in {weight_dir}")

    return load_state_dict({name: load(name) for name in _shapes(config)}, config, device)


def params_from_jax(params) -> Dict[str, np.ndarray]:
    """The JAX ``init_params`` pytree as {published name: array}."""
    return {"embed_matrix": params["embedding"], "rnn_mlstm_mlstm_wx": params["wx"],
            "rnn_mlstm_mlstm_wh": params["wh"], "rnn_mlstm_mlstm_wmx": params["wmx"],
            "rnn_mlstm_mlstm_wmh": params["wmh"], "rnn_mlstm_mlstm_b": params["b"],
            "fully_connected_weights": params["head"]["w"],
            "fully_connected_biases": params["head"]["b"]}


def ar_loss(model: UniRep, batch: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of the non-pad next tokens of (B, T)."""
    logps = torch.log_softmax(model(batch), dim=-1)
    targets = batch[:, 1:]
    ll = logps[:, :-1].gather(-1, targets[..., None])[..., 0]
    mask = (targets != UNIREP_PAD).float()
    return -(ll * mask).sum() / mask.sum().clamp(min=1.0)


def evotune_step(model: UniRep, optimizer: torch.optim.Optimizer,
                 batch: torch.Tensor) -> torch.Tensor:
    """One Adam step on ``ar_loss`` of ``batch``; returns the loss (before
    the step)."""
    optimizer.zero_grad(set_to_none=True)
    loss = ar_loss(model, batch)
    loss.backward()
    optimizer.step()
    return loss.detach()


def evotune(model: UniRep, sequences: Sequence[str], steps: int = 100, batch_size: int = 32,
            learning_rate: float = 1e-4, seed: int = 0,
            weights: Optional[np.ndarray] = None) -> UniRep:
    """Per-family AR finetuning, in place (ref unirep_evotune.py, 13k steps
    there; fewer here by default): each step draws ``batch_size`` of the
    padded rows with replacement, in proportion to ``weights`` (uniform
    without), with ``torch.multinomial`` on a generator seeded ``seed``,
    and takes one Adam step (optax.adam's defaults). The JAX function draws
    with ``jax.random.choice``, so the two never agree draw for draw."""
    dev = model.embed_matrix.device
    tok = UniRepTokenizer()
    rows = [tok.encode(s) for s in sequences]
    data = np.full((len(rows), max(len(r) for r in rows)), UNIREP_PAD, dtype=np.int64)
    for i, r in enumerate(rows):
        data[i, :len(r)] = r
    data = torch.from_numpy(data).to(dev)
    probs = (np.asarray(weights, np.float64) / np.sum(weights) if weights is not None
             else np.full(len(rows), 1.0 / len(rows)))
    probs = torch.as_tensor(probs, dtype=torch.float32, device=dev)
    gen = seeded_generator(seed, dev)
    bsz = min(batch_size, len(rows))
    model.requires_grad_(True)
    optimizer = adam(model, learning_rate)
    for _ in range(steps):
        idx = torch.multinomial(probs, bsz, replacement=True, generator=gen)
        evotune_step(model, optimizer, data[idx])
    return model.requires_grad_(False)
