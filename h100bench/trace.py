"""The traced part of a run: ``torch.profiler`` over a fixed part of the
window, kept in memory, and the spans and counters the benchmark records
around the calls into each layer of the port.

- ``Forward`` wraps the callable that the harness hands the model: it
  counts the tokens of the rows it is handed, and inside the traced part
  marks each forward with the span ``h100bench.forward``.
- ``AttentionProbe`` wraps the port's attention entry where a model binds
  it (``esm2.mha_natural``, ``ar_zoo.mha``) in the span ``h100bench.attn``
  and records each call's shapes and live (unmasked) extents, from which
  ``least_seconds`` is the least time the card could take for them.
- ``parse`` reads the profiler's events: the device's busy intervals, the
  device time of the kernels launched inside the attention spans, the
  costliest device operations and the idle gaps by what the host was
  doing.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from h100bench import peaks, stats

PART, ATTN, FORWARD, CALL = "h100bench.part", "h100bench.attn", "h100bench.forward", "h100bench.call"
_SPANS = (PART, ATTN, FORWARD, CALL)


def _device_op(e) -> bool:
    """A kernel, copy or fill on the device: a device event that is not the
    device-side shadow of a span (``gpu_user_annotation``)."""
    if e.device_type() == torch.autograd.DeviceType.CPU or e.name() in _SPANS:
        return False
    user = getattr(e, "is_user_annotation", None)
    if user is not None and user():
        return False
    kind = getattr(e, "activity_type", None)
    return kind is None or "annotation" not in str(kind())


def span(name: str, on: bool = True):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


class Forward:
    """The model callable the harness is handed, with a count of the tokens
    in the rows it gets (``handed``)."""

    def __init__(self, fn):
        self.fn = fn
        self.handed = 0
        self.spans = False

    def __call__(self, tokens, *args, **kwargs):
        self.handed += tokens.numel()
        with span(FORWARD, self.spans):
            return self.fn(tokens, *args, **kwargs)


class AttentionProbe:
    """Patches ``module.attr`` (the attention entry as a model binds it)
    for the life of the ``with`` block. ``layout`` is ``bthd`` (q is (B, T,
    H, D)) or ``bhtd``. A call with a key mask has its live keys per row
    counted on the device, once per mask and before the span opens, and
    read after the block; every query row is taken as live where its key
    is (the models here mask keys by padding)."""

    def __init__(self, module, attr: str, layout: str):
        self.module, self.attr, self.layout = module, attr, layout
        self.calls: List[Tuple[int, int, int, bool, object]] = []
        self.unsupported = 0
        self._live: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}

    def __enter__(self):
        self.orig = getattr(self.module, self.attr)
        orig = self.orig

        def probed(q, k, v, *args, **kwargs):
            self._record(q, kwargs)
            with span(ATTN):
                return orig(q, k, v, *args, **kwargs)

        setattr(self.module, self.attr, probed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)
        return False

    def _record(self, q, kwargs):
        if self.layout == "bthd":
            b, t, h, d = q.shape
        else:
            b, h, t, d = q.shape
        if kwargs.get("segment_ids") is not None or kwargs.get("bias") is not None:
            self.unsupported += 1
            return
        mask = kwargs.get("key_mask")
        if mask is None:
            live = [t] * b
        else:
            key = (id(mask), mask.data_ptr())
            if key not in self._live:  # the tensor is kept, so its id is not reused
                self._live[key] = (mask, mask.sum(dim=-1))
            live = self._live[key][1]
        self.calls.append((h, d, t, bool(kwargs.get("causal", False)), live))

    def least_seconds(self) -> Optional[float]:
        """Sum over the calls of max(operations / bf16 peak, bytes / HBM
        bandwidth): 4 H D live^2 operations a row (halved when causal) and
        q, k, v and o at 2 bytes an element over the live rows, whatever
        the dtype. None when a call was of a kind this does not count."""
        if self.unsupported or not self.calls:
            return None
        total = 0.0
        for h, d, t, causal, live in self.calls:
            rows = live.tolist() if torch.is_tensor(live) else live
            flops = sum(4.0 * h * d * n * n for n in rows) * (0.5 if causal else 1.0)
            nbytes = 2.0 * 4 * h * d * sum(rows)
            total += peaks.bound(flops, nbytes)["bound_ms"] / 1e3
        return total


@dataclasses.dataclass
class PartTrace:
    window_s: float
    busy_s: float
    attn_device_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    diagnostics: Dict[str, object]


def parse(prof, max_labelled_gaps: int = 4000) -> PartTrace:
    """The part's reading from a finished ``torch.profiler.profile``."""
    cpu, device, parts, attn = [], [], [], []
    for e in prof.profiler.kineto_results.events():
        start, end, name = e.start_ns(), e.end_ns(), e.name()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            cpu.append((start, end, name, e.correlation_id()))
            if name == PART:
                parts.append((start, end))
            elif name == ATTN:
                attn.append((start, end))
        elif _device_op(e):
            device.append((start, end, name, e.linked_correlation_id(), e.correlation_id()))
    if len(parts) != 1:
        raise RuntimeError(f"{len(parts)} spans {PART!r} in the trace, expected one")
    lo, hi = parts[0]
    attn.sort()
    attn_starts = [s for s, _ in attn]
    # a kernel names the host op open at its launch (linked correlation);
    # one launched outside any torch op (the port's ctypes entries) is
    # found through its runtime launch call (CUPTI correlation)
    op_start = {c[3]: c[0] for c in cpu if not c[2].startswith("cu")}
    launch_start = {c[3]: c[0] for c in cpu if c[2].startswith("cu")}

    def in_attn(t):
        i = bisect.bisect_right(attn_starts, t) - 1
        return i >= 0 and attn[i][0] <= t <= attn[i][1]

    attn_ns = 0
    found = {"by_op": 0, "by_launch": 0, "unlinked": 0}
    by_name: Dict[str, int] = {}
    for s, e, name, linked, corr in device:
        by_name[name] = by_name.get(name, 0) + (e - s)
        at = op_start.get(linked) if linked else None
        if at is not None:
            found["by_op"] += 1
        else:
            at = launch_start.get(corr)
            found["by_launch" if at is not None else "unlinked"] += 1
        if at is not None and in_attn(at):
            attn_ns += e - s
    busy = stats.union(stats.clip([(s, e) for s, e, _, _, _ in device], lo, hi))
    idle = stats.gaps(busy, lo, hi)
    kinds: Dict[str, float] = {}
    for name, ns in by_name.items():
        kinds[kernel_kind(name)] = kinds.get(kernel_kind(name), 0.0) + ns / 1e9
    labels = _label_gaps(sorted(idle, key=lambda g: g[0] - g[1])[:max_labelled_gaps], cpu)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return PartTrace(
        window_s=(hi - lo) / 1e9,
        busy_s=stats.covered(busy) / 1e9,
        attn_device_s=attn_ns / 1e9,
        device_ops=[(n, ns / 1e9) for n, ns in top],
        idle_gaps=[(n, ns / 1e9) for n, ns in sorted(labels.items(), key=lambda kv: -kv[1])[:10]],
        diagnostics=dict(found, device_ops=len(device), attn_spans=len(attn),
                         cpu_events=len(cpu), seconds_by_kind=kinds),
    )


def kernel_kind(name: str) -> str:
    """The kind of a device kernel, from its name: dense products, the
    normal draws, Adam, the batch draw, or elementwise and reductions.
    Copied from ``chip_smoke.kernel_kind``."""
    low = name.lower()
    if any(key in low for key in ("gemm", "cutlass", "xmma", "splitk", "nvjet")):
        return "GEMM"
    if "adam" in low:
        return "Adam"
    if "multinomial" in low:
        return "batch draw"
    if "normal" in low or "randn" in low:
        return "normal draws"
    return "elementwise and reductions"


def _label_gaps(gap_list, cpu) -> Dict[str, int]:
    """Idle nanoseconds by the innermost host event open at each gap's
    midpoint (the latest-starting one that contains it)."""
    events = sorted((s, e, name) for s, e, name, _ in cpu if name != PART)
    starts = [s for s, _, _ in events]
    out: Dict[str, int] = {}
    for g0, g1 in gap_list:
        mid = (g0 + g1) // 2
        label = "host outside any op or span"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - 20000), -1):
            s, e, name = events[j]
            if e >= mid:
                label = name
                break
        out[label] = out.get(label, 0) + (g1 - g0)
    return out


@contextlib.contextmanager
def profiled(device: torch.device):
    """``torch.profiler`` (CPU and, on a card, CUDA) around the block, the
    block in the span ``h100bench.part`` and ended by a synchronise; yields
    a box whose ``prof`` is the finished profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    box = type("Box", (), {})()
    with profile(activities=acts) as prof:
        with span(PART):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            yield box
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    box.prof = prof
