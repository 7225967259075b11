"""The port's host library: the affine-gap global aligner (Gotoh) that
realigns Tranception's and TranceptEVE's retrieval priors to every indel
sequence, the neighbour-joining tree that GEMME and SiteRM build from
the alignment, and the greedy coverage / identity row filter that stands
in for hhfilter (counterparts of ``affine_align``, ``nj_tree`` and
``hhfilter_mask`` in proteingym_tpu/native).

Each source (``pgym_align.cpp``, ``pgym_nj.cpp``, ``pgym_hhfilter.cpp``)
is compiled by ``g++ -O3 -shared -fPIC -ffp-contract=off`` at first use
into ``proteingym_tpu_torch/_build/`` (listed in .gitignore), under a name that
carries a hash of the source and the flags, so an edited source is rebuilt
and a stale library is never loaded. Importing this module builds
nothing. A failed build raises with the compiler's output: there is no
fallback aligner, tree or filter.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "pgym_align.cpp"
NJ_SOURCE = Path(__file__).resolve().parent / "pgym_nj.cpp"
HHFILTER_SOURCE = Path(__file__).resolve().parent / "pgym_hhfilter.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
# -ffp-contract=off: no product is fused into an add unless the source
# says so (pgym_nj.cpp writes the JAX library's two fused multiply-adds
# as std::fma), whatever the host's instruction set
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", "-ffp-contract=off"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_nj_lib: Optional[ctypes.CDLL] = None
_hhfilter_lib: Optional[ctypes.CDLL] = None


def library_path(source: Path = SOURCE) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + source.read_bytes())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def _build(source: Path, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, str(source), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        os.unlink(tmp)
        raise RuntimeError(f"could not run {CXX!r} to build {source.name}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{CXX} failed to build {source.name} (exit {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: a concurrent build loses nothing


def _load(source: Path) -> ctypes.CDLL:
    """Build ``source`` (if its library is not there yet) and load it."""
    path = library_path(source)
    if not path.exists():
        _build(source, path)
    return ctypes.CDLL(str(path))


def get_lib() -> ctypes.CDLL:
    """Build (if needed) and load the aligner's library; cached per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = _load(SOURCE)
            i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            lib.pgym_affine_align_batch.argtypes = [
                i8p, ctypes.c_int64, i8p, i64p, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, i32p, i32p, i64p,
            ]
            lib.pgym_affine_align_batch.restype = None
            _lib = lib
        return _lib


def _align(
    a: np.ndarray,
    queries: Sequence[np.ndarray],
    match: int = 200,
    mismatch: int = -100,
    gap_open: int = -1000,
    gap_extend: int = -50,
) -> List[Tuple[int, np.ndarray, np.ndarray]]:
    """Global affine-gap alignment (Gotoh) of the int8 code array ``a``
    (0 never matches) against every query, in one foreign call on every
    CPU this process may use. The interpreter lock is released once for
    the whole batch, so a busy Python thread elsewhere in the process does
    not stall the pairs."""
    lib = get_lib()
    a = np.ascontiguousarray(a, dtype=np.int8)
    qs = [np.ascontiguousarray(q, dtype=np.int8) for q in queries]
    offsets = np.zeros(len(qs) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum([len(q) for q in qs])
    b_all = np.concatenate(qs) if qs else np.zeros(0, dtype=np.int8)
    out_a = np.full((len(qs), len(a)), -1, dtype=np.int32)
    out_b = np.full(int(offsets[-1]), -1, dtype=np.int32)
    lengths = np.zeros(len(qs), dtype=np.int64)
    lib.pgym_affine_align_batch(a, len(a), b_all, offsets, len(qs), match, mismatch,
                                gap_open, gap_extend, len(os.sched_getaffinity(0)),
                                out_a, out_b, lengths)
    return [(int(lengths[i]), out_a[i], out_b[offsets[i]:offsets[i + 1]])
            for i in range(len(qs))]


def affine_align(a: np.ndarray, b: np.ndarray, **scores) -> Tuple[int, np.ndarray, np.ndarray]:
    """Global affine-gap alignment of two int8 code arrays, with JAX's
    defaults (match 200, mismatch -100, gap_open -1000, gap_extend -50)
    unless ``scores`` names others. Returns ``(alignment_length, a_cols,
    b_cols)``: the alignment column of each position of ``a`` and of ``b``."""
    return _align(a, [b], **scores)[0]


def affine_align_many(a: np.ndarray, queries: Sequence[np.ndarray]
                      ) -> List[Tuple[int, np.ndarray, np.ndarray]]:
    """``affine_align(a, q)`` at the default scores for every query, in
    one foreign call."""
    return _align(a, queries)


def get_nj_lib() -> ctypes.CDLL:
    """Build (if needed) and load the neighbour-joining library; cached per
    process. A library without the symbol raises (AttributeError)."""
    global _nj_lib
    with _lock:
        if _nj_lib is None:
            lib = _load(NJ_SOURCE)
            i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            lib.pgym_nj_tree.argtypes = [i8p, ctypes.c_int64, ctypes.c_int64, i32p, i32p,
                                         f64p, f64p]
            lib.pgym_nj_tree.restype = ctypes.c_int64
            _nj_lib = lib
        return _nj_lib


def nj_tree(matrix: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Neighbour-joining merge tree over the rows of an (n, L) int8 code
    matrix (0 = gap), n >= 2. Returns ``(left, right, left_len,
    right_len)``, arrays of length n - 1: internal node ``n + k`` has
    children ``left[k]`` and ``right[k]`` with those branch lengths. The
    JAX wrapper returns None without its library; this one raises."""
    matrix = np.ascontiguousarray(matrix, dtype=np.int8)
    n = matrix.shape[0]
    if n < 2:
        raise ValueError(f"a neighbour-joining tree needs >= 2 rows, got {n}")
    lib = get_nj_lib()
    left = np.zeros(n - 1, np.int32)
    right = np.zeros(n - 1, np.int32)
    left_len = np.zeros(n - 1, np.float64)
    right_len = np.zeros(n - 1, np.float64)
    k = lib.pgym_nj_tree(matrix, n, matrix.shape[1], left, right, left_len, right_len)
    if k != n - 1:
        raise RuntimeError(f"pgym_nj_tree returned {k} merges for {n} rows")
    return left, right, left_len, right_len


def get_hhfilter_lib() -> ctypes.CDLL:
    """Build (if needed) and load the row filter's library; cached per
    process."""
    global _hhfilter_lib
    with _lock:
        if _hhfilter_lib is None:
            lib = _load(HHFILTER_SOURCE)
            lib.pgym_hhfilter_mask.argtypes = [
                np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_double, ctypes.c_double, ctypes.c_double,
                np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ]
            lib.pgym_hhfilter_mask.restype = None
            _hhfilter_lib = lib
        return _hhfilter_lib


def hhfilter_mask(
    matrix: np.ndarray,
    min_coverage: float = 0.75,
    max_identity: float = 0.9,
    min_query_identity: float = 0.0,
) -> np.ndarray:
    """Boolean keep-mask over the rows of an (n, L) int8 code matrix (0 =
    gap): hhfilter '-cov 75 -id 90' analog (ref esm/compute_fitness.py:85-89).
    Row 0 always stays; a later row stays when its non-gap share is at
    least ``min_coverage``, its identity to row 0 at least
    ``min_query_identity``, and its identity to every row kept before it
    at most ``max_identity`` (identity: matches over the smaller non-gap
    count). The JAX wrapper falls back to NumPy without its library; this
    one raises."""
    matrix = np.ascontiguousarray(matrix, dtype=np.int8)
    n, length = matrix.shape
    keep = np.zeros(n, dtype=np.uint8)
    get_hhfilter_lib().pgym_hhfilter_mask(matrix, n, length, float(min_coverage),
                                          float(max_identity), float(min_query_identity), keep)
    return keep.astype(bool)
