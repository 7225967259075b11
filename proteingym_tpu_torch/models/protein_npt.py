"""ProteinNPT in PyTorch: the semi-supervised non-parametric transformer,
trained per assay (counterpart of proteingym_tpu/models/protein_npt.py;
Notin et al. 2023).

Each labelled variant is a row of per-residue features plus an embedded
target token; axial attention alternates along the residue axis (within a
variant) and the variant axis (across the batch), and hidden targets are
regressed from the target token. One (N, L+1, D) tensor a step; the GELU is
tanh's, as ``jax.nn.gelu`` defaults to it. The batch and mask draws of
``train`` come from an explicit ``torch.Generator`` on the device, or are
handed in (``draws``) to replay another run's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from proteingym_tpu_torch.devices import adam, resolve_device, seeded_generator
from proteingym_tpu_torch.models.state_dict import Named, copy_state_dict

AA20 = "ACDEFGHIKLMNPQRSTVWY"


@dataclasses.dataclass(frozen=True)
class ProteinNptConfig:
    name: str = "protein_npt"
    feat_dim: int = 21          # per-residue input features (one-hot + pad)
    embed_dim: int = 48
    num_layers: int = 2
    num_heads: int = 4
    ffn_mult: int = 4
    context_size: int = 96      # labelled rows per prediction batch
    train_batch: int = 64
    mask_rate: float = 0.25     # target-masking rate during training
    steps: int = 600
    learning_rate: float = 3e-3
    max_len: int = 2048

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


def residue_features(seqs: Sequence[str], seq_len: int) -> np.ndarray:
    """(N, L, 21) one-hot per-residue features (index 20 for any other
    letter)."""
    idx = {a: i for i, a in enumerate(AA20)}
    out = np.zeros((len(seqs), seq_len, 21), np.float32)
    for n, s in enumerate(seqs):
        for j, ch in enumerate(s[:seq_len]):
            out[n, j, idx.get(ch, 20)] = 1.0
    return out


def _attn(d, kw) -> Named:
    return Named(q=nn.Linear(d, d, **kw), k=nn.Linear(d, d, **kw), v=nn.Linear(d, d, **kw),
                 o=nn.Linear(d, d, **kw))


class ProteinNpt(nn.Module):
    """Parameters named after the JAX pytree's keys."""

    def __init__(self, c: ProteinNptConfig, device=None):
        super().__init__()
        self.config = c
        d, kw = c.embed_dim, dict(device=device)
        self.pos_embed = nn.Parameter(torch.empty(c.max_len + 1, d, **kw))
        self.in_proj = nn.Linear(c.feat_dim, d, **kw)
        self.target_proj = nn.Linear(1, d, **kw)
        self.target_mask = nn.Parameter(torch.empty(d, **kw))
        self.aux_proj = nn.Linear(1, d, **kw)
        self.layers = nn.ModuleList(
            Named(row_ln=nn.LayerNorm(d, **kw), row=_attn(d, kw), col_ln=nn.LayerNorm(d, **kw),
                  col=_attn(d, kw), ffn_ln=nn.LayerNorm(d, **kw),
                  fc1=nn.Linear(d, c.ffn_mult * d, **kw), fc2=nn.Linear(c.ffn_mult * d, d, **kw))
            for _ in range(c.num_layers))
        self.out_ln = nn.LayerNorm(d, **kw)
        self.head1 = nn.Linear(d, d, **kw)
        self.head2 = nn.Linear(d, 1, **kw)

    def forward(self, feats, targets, target_mask, aux=None):
        """feats (N, L, F); targets (N,); target_mask (N,) True = hidden;
        aux (N,) or None -> (N,) predictions read from the target token."""
        c = self.config
        n, length, _ = feats.shape
        x = self.in_proj(feats) + self.pos_embed[None, :length]
        t_emb = self.target_proj(targets[:, None])
        t_emb = torch.where(target_mask[:, None], self.target_mask, t_emb)
        if aux is not None:
            t_emb = t_emb + self.aux_proj(aux[:, None])
        x = torch.cat([x, t_emb[:, None, :]], dim=1)  # (N, L+1, D)
        for layer in self.layers:
            x = x + _mha(layer.row, layer.row_ln(x), c.num_heads)
            xc = layer.col_ln(x).transpose(0, 1)  # (L+1, N, D)
            x = x + _mha(layer.col, xc, c.num_heads).transpose(0, 1)
            h = layer.ffn_ln(x)
            x = x + layer.fc2(F.gelu(layer.fc1(h), approximate="tanh"))
        t = self.out_ln(x[:, -1])
        return self.head2(F.gelu(self.head1(t), approximate="tanh"))[:, 0]


def _mha(p: Named, x, heads: int):
    """Self-attention over the second-to-last axis of (..., T, D)."""
    *lead, t, d = x.shape
    hd = d // heads
    split = lambda y: y.reshape(*lead, t, heads, hd).transpose(-3, -2)  # noqa: E731
    q, k, v = split(p.q(x)), split(p.k(x)), split(p.v(x))
    w = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
    ctx = torch.matmul(w, v).transpose(-3, -2).reshape(*lead, t, d)
    return p.o(ctx)


def _empty(c: ProteinNptConfig, device) -> ProteinNpt:
    with torch.device("meta"):
        model = ProteinNpt(c)
    return model.to_empty(device=resolve_device(device))


@torch.no_grad()
def init_random(c: ProteinNptConfig, seed: int = 0, device="cuda") -> ProteinNpt:
    """Seeded random weights with the JAX ``init_params`` distributions (the
    draws differ): dense N(0, 1/n_in), zero biases, positions and the mask
    token N(0, 0.02^2), unit LayerNorms."""
    model = _empty(c, device)
    dev = model.pos_embed.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda shape: torch.randn(tuple(shape), generator=gen, device=dev)  # noqa: E731
    for module in model.modules():
        if isinstance(module, nn.Linear):
            module.weight.copy_(randn(module.weight.shape) / math.sqrt(module.weight.shape[1]))
            module.bias.zero_()
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    model.pos_embed.copy_(randn(model.pos_embed.shape) * 0.02)
    model.target_mask.copy_(randn(model.target_mask.shape) * 0.02)
    return model


def load_state_dict(state_dict, c: ProteinNptConfig, device="cuda") -> ProteinNpt:
    return copy_state_dict(_empty(c, device), state_dict, c.name)


def params_from_jax(params) -> Dict[str, torch.Tensor]:
    """The JAX params pytree (numpy leaves) as the port's state dict."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key, value):
        sd[key] = torch.from_numpy(np.array(value, np.float32, order="C"))

    def walk(prefix, node):
        if isinstance(node, dict) and set(node) == {"w", "b"}:
            put(f"{prefix}.weight", np.asarray(node["w"]).T)
            put(f"{prefix}.bias", node["b"])
        elif isinstance(node, dict) and set(node) == {"g", "b"}:
            put(f"{prefix}.weight", node["g"])
            put(f"{prefix}.bias", node["b"])
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else k, v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}.{i}", v)
        else:
            put(prefix, node)

    walk("", params)
    return sd


def draw_batches(c: ProteinNptConfig, n: int, steps: int, gen: torch.Generator):
    """Per step the sampled rows (B = min(train_batch, N), with replacement
    only when N < B) and the hidden targets (mask_rate each, the first row
    always), drawn from ``gen``."""
    b = min(c.train_batch, n)
    dev = gen.device
    for _ in range(steps):
        if n < b:
            idx = torch.randint(0, n, (b,), generator=gen, device=dev)
        else:
            idx = torch.randperm(n, generator=gen, device=dev)[:b]
        hide = torch.rand(b, generator=gen, device=dev) < c.mask_rate
        hide[0] = True
        yield idx, hide


def train(model: ProteinNpt, c: ProteinNptConfig, feats: np.ndarray, targets: np.ndarray,
          aux: Optional[np.ndarray] = None, seed: int = 0, draws=None):
    """Per-assay training, in place: each step takes a batch of labelled
    rows, hides some of their targets, and regresses the hidden ones
    (normalised), Adam with ``optax.adam``'s update. ``draws``, a sequence of
    (rows, hidden) per step, replaces the seeded ``torch.Generator`` draws
    (its length sets the steps). Returns (model, {"mu", "sd", "losses"})."""
    dev = model.pos_embed.device
    n = feats.shape[0]
    feats_t = torch.as_tensor(np.asarray(feats, np.float32), device=dev)
    y = torch.as_tensor(np.asarray(targets, np.float32), device=dev)
    mu, sd = float(np.mean(targets)), float(np.std(targets) + 1e-8)
    y_n = (y - mu) / sd
    aux_t = None if aux is None else torch.as_tensor(np.asarray(aux, np.float32), device=dev)
    if draws is None:
        draws = draw_batches(c, n, c.steps, seeded_generator(seed, dev, stream=1))
    model.requires_grad_(True).train()
    opt = adam(model, c.learning_rate)
    losses = []
    for idx, hide in draws:
        idx, hide = (torch.as_tensor(np.array(x) if isinstance(x, np.ndarray) else x, device=dev)
                     for x in (idx, hide))
        yb = y_n[idx]
        ab = None if aux_t is None else aux_t[idx]
        opt.zero_grad(set_to_none=True)
        pred = model(feats_t[idx], torch.where(hide, 0.0, yb), hide, aux=ab)
        loss = ((pred - yb) ** 2 * hide).sum() / hide.sum().clamp(min=1)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    model.requires_grad_(False).eval()
    losses = torch.stack(losses).cpu().numpy() if losses else np.zeros(0, np.float32)
    return model, {"mu": mu, "sd": sd, "losses": losses}


@torch.no_grad()
def predict(model: ProteinNpt, c: ProteinNptConfig, norm: Dict[str, float],
            train_feats: np.ndarray, train_targets: np.ndarray, test_feats: np.ndarray,
            train_aux: Optional[np.ndarray] = None, test_aux: Optional[np.ndarray] = None,
            seed: int = 0) -> np.ndarray:
    """Test rows in chunks of 32 (the last padded with its last row) beside a
    labelled context of ``context_size`` rows from ``RandomState(seed)``;
    with context aux and no test aux the test aux is 0."""
    dev = model.pos_embed.device
    rs = np.random.RandomState(seed)
    n_ctx = min(c.context_size, len(train_targets))
    ctx_idx = rs.choice(len(train_targets), n_ctx, replace=False)
    cf = torch.as_tensor(np.asarray(train_feats[ctx_idx], np.float32), device=dev)
    cy = (torch.as_tensor(np.asarray(train_targets[ctx_idx], np.float32), device=dev)
          - norm["mu"]) / norm["sd"]
    ca = (None if train_aux is None
          else torch.as_tensor(np.asarray(train_aux[ctx_idx], np.float32), device=dev))
    chunk = 32
    mask = torch.cat([torch.zeros(n_ctx, dtype=torch.bool, device=dev),
                      torch.ones(chunk, dtype=torch.bool, device=dev)])
    targs = torch.cat([cy, torch.zeros(chunk, device=dev)])
    padded = lambda a: (np.concatenate([a, np.repeat(a[-1:], chunk - len(a), 0)])  # noqa: E731
                        if len(a) < chunk else a)
    out = np.zeros(len(test_feats))
    for s in range(0, len(test_feats), chunk):
        blk = test_feats[s:s + chunk]
        tf = torch.as_tensor(np.asarray(padded(blk), np.float32), device=dev)
        aux = None
        if ca is not None:
            ta = (torch.zeros(chunk, device=dev) if test_aux is None else
                  torch.as_tensor(np.asarray(padded(test_aux[s:s + chunk]), np.float32),
                                  device=dev))
            aux = torch.cat([ca, ta])
        pred = model(torch.cat([cf, tf]), targs, mask, aux=aux)[n_ctx:]
        out[s:s + len(blk)] = pred[:len(blk)].cpu().numpy() * norm["sd"] + norm["mu"]
    return out


def npt_cv_predict(feats: np.ndarray, targets: np.ndarray, folds: np.ndarray,
                   c: Optional[ProteinNptConfig] = None, aux: Optional[np.ndarray] = None,
                   seed: int = 0, device="cuda") -> np.ndarray:
    """Out-of-fold predictions: per fold a model from seed ``seed + fold``
    trained on the other folds, predicting the held-out variants."""
    if c is None:
        c = ProteinNptConfig(feat_dim=feats.shape[-1])
    preds = np.zeros(len(targets))
    for k in np.unique(folds):
        tr, te = folds != k, folds == k
        model = init_random(c, seed=seed + int(k), device=device)
        model, norm = train(model, c, feats[tr], targets[tr],
                            aux=None if aux is None else aux[tr], seed=seed + int(k))
        preds[te] = predict(model, c, norm, feats[tr], targets[tr], feats[te],
                            train_aux=None if aux is None else aux[tr],
                            test_aux=None if aux is None else aux[te], seed=seed)
    return preds
