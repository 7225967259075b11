"""Process meshes and parameter sharding plans on ``torch.distributed``
(counterpart of proteingym_tpu/parallel/mesh.py).

The reference has no intra-model distribution beyond naive GPT-2 layer-to-
GPU pipelining (ref: tranception/model_pytorch.py:393-423) and shards work
across assays with SLURM arrays. Here, as in the JAX package:

  - data axis:  mutant batches / masked-position chunks, split by rows
  - model axis: tensor parallelism over attention heads + FFN hidden dim
    (Megatron), for the wide models

A ``Mesh`` is a (data, model) grid over the ranks of the process group:
rank = data_index * model + model_index, with one process group per row
(the model group: the ranks that hold one copy of the model between them)
and one per column (the data group: the ranks that hold the same shard).
The process group is torchrun's (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``), or without it a world of one that meets
through a ``FileStore`` in a temporary directory; NCCL on the card, gloo
on the CPU. A plan is a plain mapping from a parameter name to the dim it
is split along over the model axis (None: replicated), where XLA takes
``PartitionSpec`` trees; the collectives are the caller's, not a
compiler's.
"""

from __future__ import annotations

import atexit
import dataclasses
import os
import shutil
import tempfile
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

_MESHES: Dict[tuple, "Mesh"] = {}
_STORE_DIRS = []


def _remove_store_dirs():
    for path in _STORE_DIRS:
        shutil.rmtree(path, ignore_errors=True)


atexit.register(_remove_store_dirs)


def init_distributed(device="cuda") -> None:
    """Join the process group unless one exists: torchrun's when its
    environment is set (the card of ``LOCAL_RANK`` made current), else a
    world of one through a ``FileStore`` in a temporary directory. NCCL
    for a CUDA device, gloo for the CPU."""
    if dist.is_initialized():
        return
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
        return
    path = tempfile.mkdtemp(prefix="pgym_store_")
    _STORE_DIRS.append(path)
    store = dist.FileStore(os.path.join(path, "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)


def launch_rank() -> int:
    """This process's rank in the world it runs in: the process group's
    when one is joined, else torchrun's ``RANK`` (the rank that
    ``init_distributed`` will join as), else 0 for a world of one."""
    if dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0)) if "WORLD_SIZE" in os.environ else 0


def shutdown() -> None:
    """Destroy the process group and forget the meshes built on it."""
    _MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) grid over ranks 0 .. data * model - 1 of the world.
    ``data_group`` / ``model_group`` are this rank's column and row (None
    on a rank outside the grid, and in a plan-only mesh)."""

    data: int = 1
    model: int = 1
    rank: int = 0
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def member(self) -> bool:
        return self.rank < self.size

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model


def make_mesh(data: int = 1, model: int = 1, device="cuda") -> Mesh:
    """Build the (data, model) mesh over the first data * model ranks of
    the process group (joined first if need be). Every rank of the world
    must call it with the same sizes: it creates the groups of every row
    and column, in one order. A world too small raises."""
    init_distributed(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    need = data * model
    if world < need:
        raise ValueError(f"Need {need} devices, have {world}")
    key = (data, model)
    if key not in _MESHES:
        data_group = model_group = None
        for d in range(data):
            group = dist.new_group([d * model + m for m in range(model)])
            if rank < need and rank // model == d:
                model_group = group
        for m in range(model):
            group = dist.new_group([d * model + m for d in range(data)])
            if rank < need and rank % model == m:
                data_group = group
        _MESHES[key] = Mesh(data, model, rank, data_group, model_group)
    return _MESHES[key]


def default_mesh(device="cuda") -> Mesh:
    """All ranks on the data axis (inference-scale default)."""
    init_distributed(device)
    return make_mesh(data=dist.get_world_size(), model=1, device=device)


def mesh_from_spec(spec: str, device="cuda") -> Mesh:
    """Build a mesh from a CLI spec like "data=4,model=2".

    Unknown axes raise; missing axes default to 1. The product must fit the
    world (make_mesh validates)."""
    axes = {"data": 1, "model": 1}
    for part in spec.split(","):
        if not part:
            continue
        key, _, val = part.partition("=")
        key = key.strip()
        if key not in axes:
            raise ValueError(f"Unknown mesh axis {key!r} (expected data/model)")
        axes[key] = int(val)
    return make_mesh(data=axes["data"], model=axes["model"], device=device)


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


def _shapes(params) -> Dict[str, tuple]:
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    return {name: tuple(value.shape) for name, value in params.items()}


def _esm_split_dim(name: str) -> Optional[int]:
    """Megatron's dim for an ESM parameter in fair-esm names: q/k/v, fc1
    and the head's dense split their output dim (0 of a torch weight and
    its bias), out_proj and fc2 their input dim (1), the embeddings the
    hidden dim (1); layer norms, the biases of out_proj and fc2 and the
    head's bias are replicated."""
    parts = name.split(".")
    if name in ("embed_tokens.weight", "embed_positions.weight"):
        return 1
    if parts[0] == "layers":
        proj, kind = ".".join(parts[2:-1]), parts[-1]
        if proj in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "fc1"):
            return 0
        if proj in ("self_attn.out_proj", "fc2") and kind == "weight":
            return 1
        return None
    if name in ("lm_head.dense.weight", "lm_head.dense.bias"):
        return 0
    return None


def esm_param_sharding(params, mesh: Mesh) -> Dict[str, Optional[int]]:
    """The tensor-parallel plan of an ESM model (an ``EsmModel`` or its
    state dict): {name: split dim or None}, Megatron's (``_esm_split_dim``).
    A dim that the model axis does not divide is replicated instead (e.g.
    a 33-entry vocab on a model axis of 2), as the JAX plan falls back."""
    plan = {}
    for name, shape in _shapes(params).items():
        dim = _esm_split_dim(name)
        plan[name] = dim if dim is not None and shape[dim] % mesh.model == 0 else None
    return plan


def generic_tp_sharding(params, mesh: Mesh, min_size: int = 1 << 16) -> Dict[str, Optional[int]]:
    """A heuristic plan for any model: a tensor of 2+ dims and at least
    ``min_size`` elements splits its largest dim over the model axis when
    the axis divides it; everything else is replicated."""
    plan = {}
    for name, shape in _shapes(params).items():
        plan[name] = None
        if mesh.model <= 1 or len(shape) < 2 or int(np.prod(shape)) < min_size:
            continue
        axis = int(np.argmax(shape))
        if shape[axis] % mesh.model == 0:
            plan[name] = axis
    return plan


def shard_params(params, plan: Mapping[str, Optional[int]], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's part of each tensor under ``plan``: the model_index-th of
    mesh.model equal chunks along its split dim (a contiguous copy), or
    the tensor itself when it is replicated."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    out = {}
    for name, value in params.items():
        dim = plan.get(name)
        out[name] = value if dim is None else \
            value.chunk(mesh.model, dim)[mesh.model_index].clone(
                memory_format=torch.contiguous_format)
    return out


def replicate(tensors, mesh: Mesh):
    """Every rank of the mesh holds rank 0's values of ``tensors`` (in place,
    by broadcast over the world); returns them."""
    for t in tensors:
        dist.broadcast(t, src=0)
    return tensors


# ---------------------------------------------------------------------------
# Megatron's two collectives, with their gradients
# ---------------------------------------------------------------------------


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group (a
    replicated activation feeding a column-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum over the group forward (a row-parallel layer's partial products);
    identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)
