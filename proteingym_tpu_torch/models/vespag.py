"""VespaG in PyTorch: per-residue substitution-landscape heads over PLM
embeddings (counterpart of proteingym_tpu/models/vespag.py; ref
proteingym/baselines/vespag/vespag/models/fnn.py:26-51, cnn.py:33-131,
models/utils.py:6-36).

  - ``fnn``       Linear stack, LeakyReLU(0.01) between layers (the published
                  ``state_dict_v2.pt``: hidden [256] over ESM2-3B's 2560-d
                  embeddings)
  - ``cnn``       Conv1d(k=7, pad=3) -> LeakyReLU -> dense stack
  - ``combined``  parallel MinimalCNN and FNN branches, concatenated into a
                  shared dense stack

A head is a dict: ``arch`` and its layers as (weight, bias) tensors in the
torch layouts, read from a published state dict by ``load_state_dict``.
Scoring follows the reference's predict path (the landscape's WT entries
zeroed, a mutant's score the sum of y[pos][to_aa], a sigmoid when
normalising); without a checkpoint ``train_from_teacher`` distils a teacher
landscape (GEMME's) with Adam, as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from proteingym_tpu_torch.data.mutants import is_wt_row
from proteingym_tpu_torch.devices import resolve_device

AA20 = "ACDEFGHIKLMNPQRSTVWY"
LEAKY_SLOPE = 0.01  # torch.nn.LeakyReLU default negative_slope


def _dense_stack(layers: List, x, final_activation: bool):
    for i, (w, b) in enumerate(layers):
        x = F.linear(x, w, b)
        if i < len(layers) - 1 or final_activation:
            x = F.leaky_relu(x, LEAKY_SLOPE)
    return x


def _conv(conv, x, final_activation: bool, fnn):
    w, b = conv
    y = F.conv1d(x.T[None], w, b, padding=(w.shape[-1] - 1) // 2)[0].T
    return _dense_stack(fnn, F.leaky_relu(y, LEAKY_SLOPE), final_activation)


def apply(head: Dict, emb: torch.Tensor) -> torch.Tensor:
    """(L, D) embeddings -> (L, 20) landscape, by the head's ``arch``."""
    emb = emb.float()
    arch = head["arch"]
    if arch == "fnn":
        return _dense_stack(head["net"], emb, final_activation=False)
    if arch == "cnn":
        return _conv(head["conv"], emb, False, head["fnn"])
    if arch == "combined":
        conv_out = _conv(head["conv_conv"], emb, True, head["conv_fnn"])
        fnn_out = _dense_stack(head["fnn"], emb, final_activation=True)
        return _dense_stack(head["combined"], torch.cat([conv_out, fnn_out], -1), False)
    raise ValueError(f"Unknown VespaG architecture {arch!r}")


def _tensor(v, device):
    t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v, np.float32))
    return t.detach().to(device=device, dtype=torch.float32).clone()


def load_state_dict(state_dict: Mapping, device="cuda") -> Dict:
    """A VespaG torch state dict (FNN / MinimalCNN / CombinedCNN), the
    architecture found from its keys (``net.N.*`` / ``conv.0.*`` +
    ``fnn.N.*`` / ``conv.conv.0.*``)."""
    dev = resolve_device(device)
    keys = set(state_dict)

    def stack(prefix):
        idx = sorted({int(k[len(prefix) + 1:].split(".")[0]) for k in keys
                      if k.startswith(prefix + ".")})
        return [(_tensor(state_dict[f"{prefix}.{i}.weight"], dev),
                 _tensor(state_dict[f"{prefix}.{i}.bias"], dev)) for i in idx]

    def conv(prefix):
        return (_tensor(state_dict[f"{prefix}.weight"], dev),
                _tensor(state_dict[f"{prefix}.bias"], dev))

    if any(k.startswith("net.") for k in keys):
        return {"arch": "fnn", "net": stack("net")}
    if any(k.startswith("conv.conv.") for k in keys):
        return {"arch": "combined", "conv_conv": conv("conv.conv.0"),
                "conv_fnn": stack("conv.fnn"), "fnn": stack("fnn"),
                "combined": stack("combined")}
    if any(k.startswith("conv.") for k in keys):
        return {"arch": "cnn", "conv": conv("conv.0"), "fnn": stack("fnn")}
    raise ValueError(f"Unrecognized VespaG state_dict layout: {sorted(keys)[:5]}...")


def state_dict_of(head: Dict) -> Dict[str, torch.Tensor]:
    """The head in the published names (layers numbered 0, 1, ...)."""
    sd = {}

    def put_stack(prefix, layers):
        for i, (w, b) in enumerate(layers):
            sd[f"{prefix}.{i}.weight"], sd[f"{prefix}.{i}.bias"] = w, b

    if head["arch"] == "fnn":
        put_stack("net", head["net"])
    elif head["arch"] == "cnn":
        sd["conv.0.weight"], sd["conv.0.bias"] = head["conv"]
        put_stack("fnn", head["fnn"])
    else:
        sd["conv.conv.0.weight"], sd["conv.conv.0.bias"] = head["conv_conv"]
        put_stack("conv.fnn", head["conv_fnn"])
        put_stack("fnn", head["fnn"])
        put_stack("combined", head["combined"])
    return sd


def params_from_jax(params) -> Dict[str, torch.Tensor]:
    """The JAX params pytree (numpy leaves) as a published-layout state dict."""
    t = lambda x: torch.from_numpy(np.array(x, np.float32, order="C"))  # noqa: E731
    stack = lambda layers: [(t(np.asarray(p["w"]).T), t(p["b"])) for p in layers]  # noqa: E731
    arch = params.get("arch", "fnn")
    if arch == "fnn":
        head = {"arch": "fnn", "net": stack(params["net"])}
    elif arch == "cnn":
        head = {"arch": "cnn", "conv": (t(params["conv"]["w"]), t(params["conv"]["b"])),
                "fnn": stack(params["fnn"])}
    else:
        c = params["conv"]
        head = {"arch": "combined", "conv_conv": (t(c["conv"]["w"]), t(c["conv"]["b"])),
                "conv_fnn": stack(c["fnn"]), "fnn": stack(params["fnn"]),
                "combined": stack(params["combined"])}
    return state_dict_of(head)


# ---------------------------------------------------------------------------
# the reference's scoring

def mask_non_mutations(landscape: np.ndarray, wt_seq: str) -> np.ndarray:
    """The landscape with every position's WT entry 0 (ref
    utils/mutations.py:69-80)."""
    out = np.asarray(landscape, np.float32).copy()
    out[np.arange(len(wt_seq)), [AA20.index(a) for a in wt_seq]] = 0.0
    return out


def score_mutants_reference(landscape: np.ndarray, wt_seq: str, mutants: Sequence[str],
                            offset_idx: int = 1, normalize: bool = True) -> np.ndarray:
    """The sum over a mutant's SAVs of the masked y[pos][to_aa], a sigmoid
    when ``normalize`` (ref predict.py:181-186, mutations.py:95-115)."""
    y = mask_non_mutations(landscape, wt_seq)
    aa_idx = {a: i for i, a in enumerate(AA20)}
    out = np.zeros(len(mutants))
    for i, m in enumerate(mutants):
        s = 0.0
        if not is_wt_row(m):
            for tok in m.split(":"):
                wt, pos, mt = tok[0], int(tok[1:-1]) - offset_idx, tok[-1]
                if wt_seq[pos] != wt:
                    raise ValueError(f"WT mismatch in {tok}")
                s += y[pos, aa_idx[mt]]
        out[i] = 1.0 / (1.0 + np.exp(-s)) if normalize else s
    return out


# ---------------------------------------------------------------------------
# the distillation path (no checkpoint)

def init_fnn(embed_dim: int = 1280, hidden_dim: int = 256, seed: int = 0, device="cuda") -> Dict:
    """A random FNN head (hidden [256]), kaiming-normal with a=1e-2 (ref
    fnn.py:44-46), zero biases: the JAX ``init_params`` distribution, drawn
    from a seeded ``torch.Generator``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    gain = math.sqrt(2.0 / (1 + 1e-2 ** 2))
    layers = []
    for n_in, n_out in ((embed_dim, hidden_dim), (hidden_dim, 20)):
        w = torch.randn((n_out, n_in), generator=gen, device=dev) * gain / math.sqrt(n_in)
        layers.append((w, torch.zeros(n_out, device=dev)))
    return {"arch": "fnn", "net": layers}


def _tensors(head: Dict) -> List[torch.Tensor]:
    out = []
    for key, val in head.items():
        if key == "arch":
            continue
        for item in (val if isinstance(val, list) else [val]):
            out.extend(item)
    return out


def train_from_teacher(head: Dict, embeddings: torch.Tensor, teacher: np.ndarray,
                       steps: int = 300, learning_rate: float = 1e-3) -> Dict:
    """Distil a teacher landscape: full-batch mean squared error, Adam with
    ``optax.adam``'s defaults and update, ``steps`` steps. Returns a new
    head; the given one is left as it is."""
    clone = lambda item: tuple(t.detach().clone() for t in item)  # noqa: E731
    new = {k: v if k == "arch" else [clone(x) for x in v] if isinstance(v, list) else clone(v)
           for k, v in head.items()}
    params = _tensors(new)
    for p in params:
        p.requires_grad_(True)
    emb = embeddings.detach().float()
    target = torch.as_tensor(np.asarray(teacher, np.float32), device=emb.device)
    opt = torch.optim.Adam(params, lr=learning_rate, fused=emb.device.type == "cuda")
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = ((apply(new, emb) - target) ** 2).mean()
        loss.backward()
        opt.step()
    for p in params:
        p.requires_grad_(False)
    return new


@torch.no_grad()
def landscape(head: Dict, embeddings: torch.Tensor) -> np.ndarray:
    """(L, D) embeddings -> (L, 20) numpy landscape."""
    return apply(head, embeddings).cpu().numpy()


def score_mutants(head: Dict, embeddings: torch.Tensor, wt_seq: str, mutants: Sequence[str],
                  offset_idx: int = 1) -> np.ndarray:
    """The distilled path's delta-landscape scores: the sum over a mutant's
    SAVs of table[pos, mt] - table[pos, wt]."""
    table = landscape(head, embeddings)
    aa_idx = {a: i for i, a in enumerate(AA20)}
    out = np.zeros(len(mutants))
    for i, m in enumerate(mutants):
        if is_wt_row(m):
            continue
        for tok in m.split(":"):
            wt, pos, mt = tok[0], int(tok[1:-1]) - offset_idx, tok[-1]
            if wt_seq[pos] != wt:
                raise ValueError(f"WT mismatch in {tok}")
            out[i] += table[pos, aa_idx[mt]] - table[pos, aa_idx[wt]]
    return out
