"""Masked-LM training step for ESM models, finetuning / evotuning
(counterpart of proteingym_tpu/models/esm_train.py).

The reference only *consumes* pretrained ESM checkpoints, but ships
family-specific evotuning for UniRep and trains EVE per family; this
module is the equivalent for the ESM family, on one device or over a
(data, model) mesh (``parallel.mesh``, ``esm2.ShardedEsm``).

As in the JAX step:

- BERT masking (``mask_batch``): 15% of the non-special positions, 80% of
  them <mask>, 10% a random amino-acid token in [4, 24), 10% kept; the
  draws come from an explicit ``torch.Generator``;
- the loss (``mlm_loss``): per sequence, the mean log-likelihood of the
  masked positions, averaged over sequences (weighted when given);
- AdamW with optax's defaults (lr 1e-4, b1 0.9, b2 0.999, eps 1e-8,
  weight decay 1e-4, on every parameter): torch's ``AdamW`` applies the same
  decoupled update, ``p - lr * (adam(g) + wd * p)``; its own default decay
  is 1e-2;
- float32 parameters, cast at each use to ``config.dtype`` (the JAX
  ``apply`` casts its float32 params where it uses them): the trainer's
  model holds float32 masters, and a parametrization hands each layer the
  cast copy of a dense or embedding weight (layer norms and the LM-head
  bias stay float32, as in the scoring model), so the gradient reaches the
  master through the cast;
- attention through the plain version, chosen explicitly
  (``flash_attention.plain_mha_bthd``): the kernels have no backward and
  refuse autograd, as the JAX step traces the XLA attention
  (``force_xla_attention``);
- ``config.remat``: each layer recomputed in the backward
  (``torch.utils.checkpoint``).

Over a mesh each data rank takes its share of the batch's rows (padded
rows weigh 0), the model ranks run Megatron's forward and backward
(``ShardedEsm.forward_local``), and the gradients and the loss are summed
over the data group before the optimizer's step, so the step is the
single-device step's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

from proteingym_tpu_torch.models.esm2 import ALPHABET, EsmConfig, EsmModel, ShardedEsm
from proteingym_tpu_torch.ops.flash_attention import plain_mha_bthd

# optax.adamw's defaults
LEARNING_RATE, BETAS, EPS, WEIGHT_DECAY = 1e-4, (0.9, 0.999), 1e-8, 1e-4
AA_TOKENS = (4, 24)  # the random token range of mask_batch, [lo, hi)


def adamw(params: Sequence[torch.Tensor]) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` with ``optax.adamw(1e-4)``'s settings; on the
    card its fused kernel."""
    params = list(params)
    return torch.optim.AdamW(params, lr=LEARNING_RATE, betas=BETAS, eps=EPS,
                             weight_decay=WEIGHT_DECAY,
                             fused=params[0].device.type == "cuda")


def mask_batch(
    generator: torch.Generator,
    tokens: torch.Tensor,
    mask_prob: float = 0.15,
    mask_token_frac: float = 0.8,
    random_token_frac: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """BERT-style masking: (masked_tokens, target_mask). Special positions
    (cls/eos/pad) are never selected. The draws (two uniforms and the
    random tokens) come from ``generator``, on the tokens' device."""
    dev = tokens.device
    special = ((tokens == ALPHABET.cls_idx) | (tokens == ALPHABET.eos_idx)
               | (tokens == ALPHABET.padding_idx))
    select = (torch.rand(tokens.shape, generator=generator, device=dev) < mask_prob) & ~special
    u = torch.rand(tokens.shape, generator=generator, device=dev)
    use_mask = select & (u < mask_token_frac)
    use_rand = select & (u >= mask_token_frac) & (u < mask_token_frac + random_token_frac)
    rand_aa = torch.randint(*AA_TOKENS, tokens.shape, generator=generator, device=dev,
                            dtype=tokens.dtype)
    out = torch.where(use_mask, torch.full_like(tokens, ALPHABET.mask_idx), tokens)
    return torch.where(use_rand, rand_aa, out), select


def _per_sequence_ll(logits, targets, target_mask):
    """Per sequence, the mean float32 log-likelihood of the masked targets
    (a row with none counts 1 in the denominator)."""
    logps = torch.log_softmax(logits.float(), dim=-1)
    tok_ll = logps.gather(-1, targets[..., None].long())[..., 0]
    total = torch.where(target_mask, tok_ll, torch.zeros_like(tok_ll)).sum(-1)
    return total / target_mask.sum(-1).clamp(min=1)


def mlm_loss(model: nn.Module, masked_tokens: torch.Tensor, targets: torch.Tensor,
             target_mask: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy over the masked positions, optionally
    sequence-weighted, through the plain (differentiable) attention."""
    per_seq = _per_sequence_ll(model(masked_tokens, attention=plain_mha_bthd), targets,
                               target_mask)
    if weights is None:
        return -per_seq.mean()
    return -(weights * per_seq).sum() / weights.sum().clamp(min=1e-9)


class _CastAtUse(nn.Module):
    """The parametrization that hands a layer its float32 master weight in
    the compute dtype."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype

    def forward(self, master):
        return master.to(self.dtype)


def float32_master(model: EsmModel, config: EsmConfig, mesh=None) -> nn.Module:
    """A trainable float32 copy of ``model``'s weights that computes as
    ``config`` says: every parameter a float32 master, and each one that an
    ``EsmModel`` stores in ``config.dtype`` (the dense and embedding
    weights) cast to that dtype at each use; over ``mesh`` this rank's
    ``ShardedEsm`` of it."""
    dev = model.embed_tokens.weight.device
    config32 = dataclasses.replace(config, dtype=torch.float32)
    master = EsmModel(config32, device=dev)
    master.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    if mesh is not None:
        master = ShardedEsm(master, mesh)
    if config.dtype != torch.float32:
        with torch.device("meta"):
            probe = EsmModel(dataclasses.replace(config, dtype=torch.bfloat16))
        for name, p in probe.named_parameters():
            if p.dtype == torch.bfloat16:
                owner, attr = name.rsplit(".", 1)
                parametrize.register_parametrization(master.get_submodule(owner), attr,
                                                     _CastAtUse(config.dtype), unsafe=True)
    return master.train().requires_grad_(True)


@dataclasses.dataclass
class TrainState:
    model: nn.Module  # float32 masters (an EsmModel, or this rank's ShardedEsm)
    optimizer: torch.optim.Optimizer
    mesh: Optional[object] = None


def make_train_step(config: EsmConfig, optimizer: Optional[Callable] = None):
    """Returns (init, train_step).

    ``init(model, mesh=None) -> TrainState``: float32 masters of the
    ``EsmModel``'s weights (this rank's shards over ``mesh``) computing in
    ``config.dtype`` with ``config.remat``, and the optimizer,
    ``optimizer(params)`` or AdamW with optax's defaults.

    ``train_step(state, tokens, seq_weights=None, generator=None,
    masked=None) -> loss``: one step on the (B, T) ``tokens`` (the whole
    batch, on every rank of a mesh); ``masked`` = (masked_tokens,
    target_mask) hands in the masking, else ``mask_batch`` draws it from
    ``generator``. The loss is returned detached, float32."""
    make_optimizer = optimizer or adamw

    def init(model: EsmModel, mesh=None) -> TrainState:
        if model.config.num_layers != config.num_layers or \
                model.config.embed_dim != config.embed_dim:
            raise ValueError(f"model {model.config.name} is not {config.name}")
        master = float32_master(model, config, mesh)
        return TrainState(master, make_optimizer(list(master.parameters())), mesh)

    def train_step(state: TrainState, tokens: torch.Tensor,
                   seq_weights: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   masked: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        masked_tokens, target_mask = masked if masked is not None else \
            mask_batch(generator, tokens)
        state.optimizer.zero_grad(set_to_none=True)
        if state.mesh is None:
            loss = mlm_loss(state.model, masked_tokens, tokens, target_mask, seq_weights)
            loss.backward()
        else:
            loss = _sharded_loss_backward(state, tokens, masked_tokens, target_mask,
                                          seq_weights)
        state.optimizer.step()
        return loss.detach()

    return init, train_step


def _sharded_loss_backward(state, tokens, masked_tokens, target_mask, weights):
    """This data rank's share of the loss, -sum(w * ll) / sum(w) over its
    rows (padded rows weigh 0), its backward through the model ranks, and
    the gradients and the loss summed over the data group."""
    mesh = state.mesh
    b = tokens.shape[0]
    if weights is None:
        weights = torch.ones(b, device=tokens.device)
    rows = -(-b // mesh.data)
    pad = rows * mesh.data - b
    if pad:  # copies of the last row, each of weight 0
        tokens, masked_tokens, target_mask = (
            torch.cat([x, x[-1:].expand(pad, -1)]) for x in (tokens, masked_tokens, target_mask))
        weights = torch.cat([weights, weights.new_zeros(pad)])
    mine = slice(mesh.data_index * rows, (mesh.data_index + 1) * rows)
    logits = state.model.forward_local(masked_tokens[mine], attention=plain_mha_bthd)
    per_seq = _per_sequence_ll(logits, tokens[mine], target_mask[mine])
    loss = -(weights[mine] * per_seq).sum() / weights.sum().clamp(min=1e-9)
    loss.backward()
    for p in state.model.parameters():
        if p.grad is not None:
            dist.all_reduce(p.grad, group=mesh.data_group)
    loss = loss.detach().clone()
    dist.all_reduce(loss, group=mesh.data_group)
    return loss
