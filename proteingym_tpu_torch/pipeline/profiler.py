"""Profiling & throughput accounting (counterpart of
proteingym_tpu/pipeline/profiler.py).

  - ``trace(logdir)``: context manager around ``torch.profiler`` with the
    CPU and CUDA activities; everything inside the block is traced and
    written, when it ends, as ``<logdir>/<host>_<pid>.<ms>.pt.trace.json``
    (``tensorboard_trace_handler``'s Chrome trace, which TensorBoard's
    PyTorch profiler plugin and chrome://tracing / Perfetto read). On a
    host without a CUDA device only the CPU is traced.
  - ``span(name)``: the port's own spans (``pgym.*``). With no profiler
    running a span is one shared ``nullcontext``; under one it is a
    ``record_function`` range, on the clock of the profiler's device
    events, and is added to this process's record: per name the count, the
    seconds and the self seconds (the seconds not covered by spans opened
    inside it on the same thread). ``span_totals()`` reads the record and
    ``clear_spans()`` empties it. This module imports nothing else of the
    port, so the kernels' entries and the models can use it.
  - ``Throughput``: mutants/sec accounting for scorer runs, emitted
    through the JSONL event log; on a CUDA host the clock stops after the
    device has finished the block's work.
"""

from __future__ import annotations

import contextlib
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

import torch

# the scoring harness's spans (models/packed_scoring, esm_scoring, ar_scoring):
# none of them holds a model forward
PLAN = "pgym.harness.plan"  # tokens, buckets, windows, work queues, slice plans
ROWS = "pgym.harness.rows"  # one forward's input rows, built and uploaded
# a copy from host memory to the device inside ``ROWS`` (the rows, or the
# scalar of a mask write): CUDA starts it only after the work queued on the
# stream, so the host waits there for the forward before
UPLOAD = "pgym.harness.upload"
READBACK = "pgym.harness.readback"  # the host's wait for the device's results
GATHER = "pgym.harness.gather"  # read-back rows into tables; the AR sums and joins
PARSE = "pgym.harness.parse"  # mutant strings to positions and tokens, table sums
LOAD = "pgym.load"  # a checkpoint loader (pipeline/checkpoints)

_OFF = contextlib.nullcontext()
_OPEN = threading.local()  # .stack: the spans open on this thread, innermost last
_LOCK = threading.Lock()
_TOTALS: Dict[str, list] = {}  # name -> [count, ns, ns covered by child spans]


class _Span:
    __slots__ = ("name", "range", "start", "children")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        stack.append(self)
        self.children = 0
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.start
        stack = _OPEN.stack
        stack.pop()
        if stack:
            stack[-1].children += ns
        with _LOCK:
            rec = _TOTALS.setdefault(self.name, [0, 0, 0])
            rec[0] += 1
            rec[1] += ns
            rec[2] += self.children
        self.range.__exit__(*exc)
        return False


def span(name: str):
    """The span ``name`` around a ``with`` block: nothing but one check
    when no profiler is running, else a ``record_function`` range that is
    also added to the record ``span_totals`` reads."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def span_totals() -> Dict[str, Tuple[int, float, float]]:
    """{name: (count, seconds, self seconds)} of the spans closed while a
    profiler ran, since the process started or ``clear_spans``."""
    with _LOCK:
        return {name: (n, ns / 1e9, (ns - child) / 1e9)
                for name, (n, ns, child) in _TOTALS.items()}


def clear_spans() -> None:
    with _LOCK:
        _TOTALS.clear()


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
        if torch.cuda.is_initialized():  # the block's kernels may still be running
            torch.cuda.synchronize()
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
