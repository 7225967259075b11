"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (sm_90a) into a
shared library with a plain C interface, under ``proteingym_tpu_torch/_build/``
(listed in .gitignore). The library's file name carries a hash of the
source and of every header it includes from ``csrc/``, so an edited source
or shared header is rebuilt and a stale library is never loaded. Nothing
is built from outside the package. ``build_all`` starts one ``nvcc`` per
source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills go to the log
]

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# seconds each library took to build in this process (absent: loaded as built)
BUILD_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (Path(home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the CUDA kernels are built from source at first use"
    )


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and the headers it includes from ``csrc/``, at
    any depth, in a fixed order."""
    files, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            header = path.parent / inc.decode()
            if header.exists():
                todo.append(header)
    return files


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start ``nvcc`` on ``csrc/<name>.cu`` into a temporary file; returns
    what ``_finish_build`` needs, or None when the library is built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = CSRC / f"{name}.cu"
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    return proc, tmp, out, src, time.perf_counter()


def _finish_build(name: str, started) -> None:
    proc, tmp, out, src, t0 = started
    stdout, stderr = proc.communicate()
    out.with_suffix(".log").write_text(stdout + stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed to build {src.name} "
            f"(exit {proc.returncode}):\n{stderr[-4000:]}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build loses nothing
    BUILD_SECONDS[name] = time.perf_counter() - t0


def build_all(names: Iterable[str]) -> None:
    """Build the libraries of ``names`` that are not built yet, one ``nvcc``
    per source, all started together."""
    with _LOCK:
        started = {n: _start_build(n) for n in names if n not in _LOADED}
        errors = []
        for name, job in started.items():
            if job is not None:
                try:
                    _finish_build(name, job)
                except RuntimeError as e:
                    errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _LOCK:
        if name in _LOADED:
            return _LOADED[name]
        job = _start_build(name)
        if job is not None:
            _finish_build(name, job)
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
        return lib


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``) of the last build of ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
