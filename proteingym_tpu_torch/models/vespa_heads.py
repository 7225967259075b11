"""VESPA's prediction heads in PyTorch: the ProtT5 conservation CNN and the
logistic SAV blend (counterpart of proteingym_tpu/models/vespa_heads.py;
Marquet et al. 2022, the Rostlab/VESPA package layout).

  - **ConsCNN**: 9-class ConSurf-scale conservation from per-residue ProtT5
    embeddings, two convolutions over the length axis (1024 -> 32, k=7,
    ReLU, 32 -> 9, k=7, SAME padding). ``load_conscnn_state_dict`` reads the
    package's ``prott5cons`` checkpoint (Conv2d kernels (out, in, 7, 1)).
  - **SAV blend**: a logistic regression over [BLOSUM62(wt, mt), the nine
    conservation probabilities, the masked log-odds of mt minus wt]; VESPAl
    drops the log-odds. ``DEFAULT_BLEND`` is the JAX package's documented
    reconstruction, copied.

``vespa_table`` returns effect probabilities (higher = more damaging);
``score_mutants`` applies ProteinGym's ingestion, the sum of log(1 - p)
over a mutant's non-synonymous singles (higher = fitter).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from proteingym_tpu_torch.data.mutants import is_wt_row
from proteingym_tpu_torch.devices import resolve_device
from proteingym_tpu_torch.models.provean import BLOSUM62, BLOSUM_ALPHABET

AA20 = "ACDEFGHIKLMNPQRSTVWY"
N_CLASSES = 9  # ConSurf conservation scale 1..9 (class 0 = most variable)
N_FEATURES = 11
DEFAULT_BLEND = {
    "w": np.concatenate([
        np.array([-0.25], np.float32),
        np.linspace(-1.0, 1.0, N_CLASSES).astype(np.float32),
        np.array([-0.5], np.float32),
    ]),
    "b": np.float32(0.0),
}


def _blosum20() -> np.ndarray:
    idx = [BLOSUM_ALPHABET.index(a) for a in AA20]
    return BLOSUM62[np.ix_(idx, idx)].astype(np.float32)


# ---------------------------------------------------------------------------
# ConsCNN

class ConsCNN(nn.Module):
    def __init__(self, d_model: int = 1024, hidden: int = 32, kernel: int = 7, device=None):
        super().__init__()
        self.conv1 = nn.Conv1d(d_model, hidden, kernel, padding=kernel // 2, device=device)
        self.conv2 = nn.Conv1d(hidden, N_CLASSES, kernel, padding=kernel // 2, device=device)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        """(L, d_model) embeddings -> (L, 9) conservation logits."""
        x = torch.relu(self.conv1(emb.float().T[None]))
        return self.conv2(x)[0].T


@torch.no_grad()
def init_conscnn(d_model: int = 1024, hidden: int = 32, kernel: int = 7, seed: int = 0,
                 device="cuda") -> ConsCNN:
    """He-normal kernels and zero biases (the JAX ``init_conscnn``
    distribution; the draws differ)."""
    dev = resolve_device(device)
    model = ConsCNN(d_model, hidden, kernel, device=dev).eval().requires_grad_(False)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for conv in (model.conv1, model.conv2):
        c_out, c_in, k = conv.weight.shape
        conv.weight.copy_(torch.randn((c_out, c_in, k), generator=gen, device=dev)
                          * (2.0 / (c_in * k)) ** 0.5)
        conv.bias.zero_()
    return model


@torch.no_grad()
def conservation_probs(model: ConsCNN, emb: torch.Tensor) -> np.ndarray:
    """(L, 9) class probabilities."""
    return torch.softmax(model(emb), dim=-1).cpu().numpy()


def _conv_keys(state_dict: Mapping):
    convs = []
    for key, val in state_dict.items():
        if key.endswith(".weight") and len(np.shape(val)) == 4:
            digits = [int(tok) for tok in key.split(".") if tok.isdigit()]
            convs.append((digits[-1] if digits else len(convs), key))
    if len(convs) != 2:
        raise ValueError(f"expected 2 Conv2d layers in a ConsCNN state dict, found "
                         f"{len(convs)}: {sorted(k for _, k in convs)}")
    return [key for _, key in sorted(convs)]


@torch.no_grad()
def load_conscnn_state_dict(state_dict: Mapping, device="cuda") -> ConsCNN:
    """The ``prott5cons`` checkpoint: its two Conv2d layers found by their
    4-dim weights, ordered by their layer index; (Cout, Cin, K, 1) kernels."""
    dev = resolve_device(device)
    keys = _conv_keys(state_dict)
    ws = [torch.as_tensor(np.asarray(state_dict[k], np.float32)
                          if not torch.is_tensor(state_dict[k]) else state_dict[k]).float()
          for k in keys]
    for key, w in zip(keys, ws):
        if w.shape[-1] != 1:
            raise ValueError(f"{key}: expected trailing kernel dim 1, got {tuple(w.shape)}")
    if ws[1].shape[0] != N_CLASSES:
        raise ValueError(f"final layer has {ws[1].shape[0]} outputs, expected {N_CLASSES} "
                         "conservation classes")
    c_hidden, c_in, k = ws[0].shape[:3]
    model = ConsCNN(c_in, c_hidden, k, device=dev).eval().requires_grad_(False)
    for conv, key, w in zip((model.conv1, model.conv2), keys, ws):
        bias = state_dict[key[: -len("weight")] + "bias"]
        conv.weight.copy_(w[..., 0])
        conv.bias.copy_(torch.as_tensor(np.asarray(bias, np.float32)) if not torch.is_tensor(bias)
                        else bias.float())
    return model


def conscnn_params_from_jax(params) -> Dict[str, torch.Tensor]:
    """The JAX ConsCNN pytree as a ``prott5cons``-layout state dict (layers
    0 and 3 of its Sequential)."""
    sd = {}
    for name, idx in (("conv1", 0), ("conv2", 3)):
        w = np.asarray(params[name]["w"], np.float32)  # (K, Cin, Cout)
        sd[f"{idx}.weight"] = torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0)[..., None]))
        sd[f"{idx}.bias"] = torch.from_numpy(np.array(params[name]["b"], np.float32))
    return sd


# ---------------------------------------------------------------------------
# SAV logistic blend (numpy, as in the JAX package)

def sav_features(cons_probs: np.ndarray, logodds_table: Optional[np.ndarray]) -> np.ndarray:
    """(L, 20, 11) features of every SAV, the BLOSUM column left to
    ``vespa_table``; without a log-odds table (VESPAl) its feature is 0."""
    L = cons_probs.shape[0]
    feats = np.zeros((L, 20, N_FEATURES), np.float32)
    feats[:, :, 1:1 + N_CLASSES] = cons_probs[:, None, :]
    if logodds_table is not None:
        feats[:, :, -1] = logodds_table
    return feats


def vespa_table(wt_seq: str, cons_probs: np.ndarray, logodds_table: Optional[np.ndarray] = None,
                blend: Optional[Dict] = None) -> np.ndarray:
    """(L, 20) effect probabilities of every SAV of ``wt_seq`` (WT cells 0,
    rows of a wild type outside AA20 NaN). ``logodds_table``: (L, 20) log
    P(aa | mask at pos) in AA20 order, or None for VESPAl."""
    L = len(wt_seq)
    if cons_probs.shape != (L, N_CLASSES):
        raise ValueError(f"cons_probs {cons_probs.shape} != ({L}, 9)")
    blend = blend or DEFAULT_BLEND
    w = np.asarray(blend["w"], np.float32)
    b = float(blend["b"])
    n_active = N_FEATURES if logodds_table is not None else N_FEATURES - 1
    if w.shape not in ((N_FEATURES,), (n_active,)):
        raise ValueError(f"blend weights {w.shape} != ({N_FEATURES},)"
                         + (f" or ({n_active},) in VESPAl/light mode"
                            if logodds_table is None else ""))
    feats = sav_features(np.asarray(cons_probs, np.float32),
                         None if logodds_table is None else np.asarray(logodds_table, np.float32))
    aa_idx = {a: i for i, a in enumerate(AA20)}
    known = np.array([a in aa_idx for a in wt_seq])
    wt_rows = np.array([aa_idx.get(a, 0) for a in wt_seq])
    feats[:, :, 0] = _blosum20()[wt_rows]
    if logodds_table is not None:
        wt_lo = np.asarray(logodds_table, np.float32)[np.arange(L), wt_rows]
        feats[:, :, -1] -= wt_lo[:, None]
    logits = feats[:, :, :w.shape[0]] @ w + b
    table = 1.0 / (1.0 + np.exp(-logits))
    table[np.arange(L), wt_rows] = 0.0
    table[~known] = np.nan
    return table


def score_mutants(table: np.ndarray, wt_seq: str, mutants) -> np.ndarray:
    """ProteinGym's ingestion of VESPA's output (ref
    baselines/vespa/compute_fitness.py:90-108): the sum of log(1 - p) over a
    mutant's non-synonymous singles, p clipped below 1 - 1e-7; synonymous
    singles skipped, a literal WT row 0. Higher is fitter."""
    aa_idx = {a: i for i, a in enumerate(AA20)}
    out = np.zeros(len(mutants), np.float32)
    for i, m in enumerate(mutants):
        if is_wt_row(m):
            continue
        total = 0.0
        for tok in str(m).split(":"):
            wt, pos, mt = tok[0], int(tok[1:-1]) - 1, tok[-1]
            if wt_seq[pos] != wt:
                raise ValueError(f"WT mismatch in {tok}")
            if wt == mt:
                continue
            if mt not in aa_idx:
                raise ValueError(f"mutant amino acid {mt!r} in {tok} is outside the 20 standard "
                                 "residues; VESPA cannot score it")
            p = table[pos, aa_idx[mt]]
            if not np.isfinite(p):
                raise ValueError(f"position {pos + 1} has non-AA20 wild type {wt_seq[pos]!r}; "
                                 f"VESPA cannot score {tok}")
            total += float(np.log1p(-min(float(p), 1.0 - 1e-7)))
        out[i] = total
    return out
