"""Profiling & throughput accounting (counterpart of
proteingym_tpu/pipeline/profiler.py).

  - ``trace(logdir)``: context manager around ``torch.profiler`` with the
    CPU and CUDA activities; everything inside the block is traced and
    written, when it ends, as ``<logdir>/<host>_<pid>.<ms>.pt.trace.json``
    (``tensorboard_trace_handler``'s Chrome trace, which TensorBoard's
    PyTorch profiler plugin and chrome://tracing / Perfetto read). On a
    host without a CUDA device only the CPU is traced.
  - ``Throughput``: mutants/sec accounting for scorer runs, emitted
    through the JSONL event log.
  - ``device_memory_stats``: per-device memory snapshot from
    ``torch.cuda.memory_stats``.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Any, Dict

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of everything inside the block
    into ``logdir``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    Path(logdir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(logdir))):
        yield


def device_memory_stats() -> Dict[str, Any]:
    """{device: bytes in use, peak bytes, bytes the allocator reserved} for
    every visible CUDA device; empty without one."""
    out = {}
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_reserved": stats.get("reserved_bytes.all.current"),
        }
    return out


class Throughput:
    """Mutants/sec accounting across assays; integrates with EventLog."""

    def __init__(self, event_log=None):
        self.event_log = event_log
        self.total_mutants = 0
        self.total_seconds = 0.0

    @contextlib.contextmanager
    def measure(self, n_mutants: int, label: str = ""):
        start = time.perf_counter()
        yield
        dt = time.perf_counter() - start
        self.total_mutants += n_mutants
        self.total_seconds += dt
        if self.event_log is not None:
            self.event_log.emit(
                "throughput",
                label=label,
                n_mutants=n_mutants,
                seconds=round(dt, 4),
                mutants_per_sec=round(n_mutants / max(dt, 1e-9), 2),
            )

    @property
    def mutants_per_sec(self) -> float:
        return self.total_mutants / max(self.total_seconds, 1e-9)

    def summary(self) -> Dict[str, float]:
        return {
            "total_mutants": self.total_mutants,
            "total_seconds": round(self.total_seconds, 3),
            "mutants_per_sec": round(self.mutants_per_sec, 2),
        }
