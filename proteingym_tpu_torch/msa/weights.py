"""EVE/EVcouplings sequence cluster weights (counterpart of
proteingym_tpu/msa/weights.py).

    w_i = 1 / #{ j : matches(i, j) > identity_threshold * max(L_nongap(i), 1) }

matches(i, j) counts the columns where sequences i and j hold the same amino
acid (codes 1..20; gaps, code 0, and any other code never match);
L_nongap(i) counts the nonzero codes of row i. The comparison is the TPU
kernel's: strict, in float32, with the threshold computed in float32. The
count includes self; all-gap rows get count 0 and weight 0.

``num_cluster_members_cuda`` wraps the CUDA kernel ``csrc/cluster_counts.cu``,
the port of the Pallas kernel inside ``num_cluster_members_pallas``: an int8
one-hot pre-pass, then a tensor-core Gram over the upper-triangle tiles,
with the threshold count fused in. ``one_hot_nogap`` is
the pre-pass's plain version (the layout the kernel reads).
``num_cluster_members`` is the kernel's plain version: a blocked Gram matrix
of the gap-free one-hot, float32 on the CPU and bf16 on the GPU (where it
serves only as the kernel's comparison). ``sequence_weights`` runs the kernel
for ``device="cuda"`` and the plain version for ``device="cpu"``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from proteingym_tpu_torch.constants import ALPHABET_PROTEIN_NOGAP
from proteingym_tpu_torch.devices import resolve_device

NUM_AA = len(ALPHABET_PROTEIN_NOGAP)

# launches of the CUDA kernel in this process, counted by its wrapper where
# it launches the kernel and nowhere else
LAUNCHES = {"cluster_counts": 0}

# bf16 holds every integer up to 256 exactly, so a bf16 Gram over at most
# this many columns gives exact match counts whatever the output rounding
_EXACT_BF16_COLUMNS = 256
_ROW_BLOCK = 512  # rows of the plain version's Gram per matmul

# the kernel's one-hot depth per ring stage (one 128-byte swizzle row), kBK
# of csrc/cluster_counts.cu: the one-hot's rows are padded to it, and the
# kernel's entry refuses a depth that is not a multiple of it
K_ALIGN = 128


def _prepare(matrix, identity_threshold: float, device):
    """(N, L) codes -> (int32 codes, L_nongap, float32 thresholds), all on
    ``device``. Codes outside 1..20 are passed on as they are: neither the
    plain version nor the kernel lets them match."""
    m = torch.as_tensor(matrix).to(device=device, dtype=torch.int32)
    if m.ndim != 2:
        raise ValueError(f"expected an (N, L) code matrix, got shape {tuple(m.shape)}")
    l_non_gap = (m != 0).sum(dim=1)
    # float32(identity) * max(L_nongap, 1), rounded once to float32: the
    # scalar is the float32 value, and a Python number makes no device tensor
    # (a blocking copy that would stall the caller's queue)
    thr = l_non_gap.clamp(min=1).to(torch.float32) * float(np.float32(identity_threshold))
    return m, l_non_gap, thr


def num_cluster_members(matrix, identity_threshold: float) -> torch.Tensor:
    """Neighbour counts (inverse weights), the plain version: float32 (N,)
    counts including self, 0 for all-gap rows, on the matrix's device (a
    numpy matrix: the CPU)."""
    device = matrix.device if torch.is_tensor(matrix) else "cpu"
    codes, l_non_gap, thr = _prepare(matrix, identity_threshold, device)
    n, length = codes.shape
    dtype = torch.bfloat16 if codes.is_cuda else torch.float32
    aa = torch.arange(1, NUM_AA + 1, device=codes.device, dtype=codes.dtype)
    # one-hot of each column chunk, (N, columns * 20)
    onehots = [
        (codes[:, c0:c0 + _EXACT_BF16_COLUMNS, None] == aa).to(dtype).reshape(n, -1)
        for c0 in range(0, length, _EXACT_BF16_COLUMNS)
    ]
    counts = torch.empty(n, dtype=torch.float32, device=codes.device)
    for r0 in range(0, n, _ROW_BLOCK):
        rows = slice(r0, r0 + _ROW_BLOCK)
        matches = sum(torch.matmul(oh[rows], oh.t()).float() for oh in onehots)
        counts[rows] = (matches > thr[rows, None]).sum(dim=1).float()
    return torch.where(l_non_gap > 0, counts, torch.zeros_like(counts))


def one_hot_depth(length: int) -> int:
    """Bytes per row of the kernel's one-hot: 20 L padded to K_ALIGN."""
    return max(1, -(-NUM_AA * length // K_ALIGN)) * K_ALIGN


def one_hot_nogap(codes: torch.Tensor) -> torch.Tensor:
    """The kernel pre-pass's plain version: (N, L) codes -> int8 (N, K_pad)
    one-hot, column c's 20 channels at 20 c .. 20 c + 19 (code a at 20 c +
    a - 1), zero for codes outside 1..20 and past 20 L."""
    n, length = codes.shape
    out = torch.zeros((n, one_hot_depth(length)), dtype=torch.int8, device=codes.device)
    aa = torch.arange(1, NUM_AA + 1, device=codes.device, dtype=codes.dtype)
    out[:, :NUM_AA * length] = (codes[:, :, None] == aa).reshape(n, -1).to(torch.int8)
    return out


@functools.lru_cache(maxsize=1)
def _kernel_lib():
    from proteingym_tpu_torch.ops._build import load_library

    lib = load_library("cluster_counts")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pgym_cluster_counts.argtypes = [vp, i32, i32, vp, vp, vp, i32, vp]
    lib.pgym_cluster_counts.restype = i32
    lib.pgym_cluster_error_string.argtypes = [i32]
    lib.pgym_cluster_error_string.restype = ctypes.c_char_p
    return lib


def num_cluster_members_cuda(matrix: torch.Tensor, identity_threshold: float) -> torch.Tensor:
    """Neighbour counts on the Hopper kernel: ``matrix`` an (N, L) integer
    CUDA tensor; returns float32 (N,) counts on the same device."""
    if not torch.is_tensor(matrix) or matrix.device.type != "cuda":
        raise ValueError("num_cluster_members_cuda takes a CUDA tensor")
    codes, l_non_gap, thr = _prepare(matrix, identity_threshold, matrix.device)
    codes = codes.contiguous()
    n, length = codes.shape
    if n == 0:
        return torch.zeros(0, dtype=torch.float32, device=matrix.device)
    k_pad = one_hot_depth(length)
    onehot = torch.empty((n, k_pad), dtype=torch.int8, device=codes.device)  # pre-pass output
    counts = torch.zeros(n, dtype=torch.int32, device=codes.device)
    lib = _kernel_lib()
    with torch.cuda.device(codes.device):
        err = lib.pgym_cluster_counts(
            codes.data_ptr(), n, length, thr.data_ptr(), counts.data_ptr(),
            onehot.data_ptr(), k_pad, torch.cuda.current_stream(codes.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError("cluster_counts launch failed: "
                           + lib.pgym_cluster_error_string(err).decode())
    LAUNCHES["cluster_counts"] += 1
    counts = counts.to(torch.float32)
    return torch.where(l_non_gap > 0, counts, torch.zeros_like(counts))


def sequence_weights(
    matrix: np.ndarray,
    theta: float = 0.2,
    identity_threshold: Optional[float] = None,
    device="cuda",
) -> np.ndarray:
    """Cluster weights w_i = 1 / neighbour_count_i (ref weights.py:13-53) as
    float64 numpy, 0 for all-gap rows. ``matrix``: (N, L) int codes with
    0 = gap; theta is the EVE hyperparameter (identity_threshold =
    1 - theta). ``device="cuda"`` runs the Hopper kernel, ``"cpu"`` the
    plain version; there is no fallback between them."""
    if identity_threshold is None:
        identity_threshold = 1.0 - theta
    dev = resolve_device(device)
    m = torch.as_tensor(np.asarray(matrix))
    if dev.type == "cuda":
        counts = num_cluster_members_cuda(m.to(dev), identity_threshold)
    elif dev.type == "cpu":
        counts = num_cluster_members(m, identity_threshold)
    else:
        raise ValueError(f"no sequence-weight path for device {dev}")
    # integer counts divided in float64, as the JAX package's CPU route
    # divides its counts (its TPU route divides in float32)
    counts = counts.cpu().numpy().astype(np.float64)
    weights = np.zeros(m.shape[0], dtype=np.float64)
    nonzero = counts > 0
    weights[nonzero] = 1.0 / counts[nonzero]
    return weights
