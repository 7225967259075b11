#!/usr/bin/env python3
"""Run one cell of the port's H100 benchmark once.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up draws the weights and the traffic from
``--seed`` on the card, builds the port's model through its own loader and
warms up the cell's shapes; the window then calls the port's scoring
entry back to back (a closed loop, one caller) for ``--seconds``. With
``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from ``torch.profiler`` over a
fixed part of the window. After the window the plain reference scores a
sample of the window's mutants again, and ``correct`` says whether every
number compared stays within its limit (``checks/<cell>.json``).

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``); the numbers compared, each beside its
limit, are also the last lines of standard error. The run exits with
another code than 0, and prints no result, where torch sees fewer cards
than the cell asks for, where the port is not this checkout's, or where
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".h100bench_cache"
# the program's build and kernel caches: fixed directories in the checkout
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

_T_TORCH = time.perf_counter() - _T0

from h100bench import trace as tr  # noqa: E402
from h100bench.bench import Cell, load_cell  # noqa: E402
from h100bench.guard import forbidden_modules  # noqa: E402
from h100bench.precision import Precision  # noqa: E402


def log(*parts) -> None:
    print("[h100bench]", *parts, file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(cell: Cell, seed: int, device: torch.device):
    """Traffic and weights from the seed, the port's model, and one warm-up
    of each of the cell's shapes and of its entry."""
    cfg, traffic, fam, kind = cell.config, cell.traffic, cell.family, cell.kind
    stages = {}
    t = time.perf_counter()

    def stage(name):
        nonlocal t
        _sync(device)
        now = time.perf_counter()
        stages[name] = round(now - t, 3)
        t = now

    torch.zeros(1, device=device)
    stage("device")
    pool = kind.make_pool(traffic, cfg, seed)
    stage("traffic")
    weights = fam.make_weights(cfg, seed, device)
    stage("weights")
    program = fam.build(cfg, weights, device)
    del weights
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    stage("load")
    forward = tr.Forward(program.logits_fn)
    with torch.no_grad():
        for rows, length in kind.shapes(traffic, cfg):
            forward(torch.zeros(rows, length, dtype=torch.long, device=device))
        stage("warm-up shapes")
        kind.call(program, forward, kind.warm_up_payload(traffic, cfg), traffic, cfg, device)
    forward.handed = 0
    stage("warm-up entry")
    log(f"set-up stages (s): {stages}")
    return pool, program, forward


def run_window(cell: Cell, pool, program, forward, seconds: float, trace: bool,
               device: torch.device):
    """Calls back to back until ``seconds`` have passed and the ladder's
    cycle in progress has ended (so that every window holds whole cycles
    of the mix), and with ``trace`` the fixed part ``traffic['profile']``
    under the profiler. Returns the records, the window's seconds and the
    traced part's reading (or None)."""
    cfg, traffic, kind = cell.config, cell.traffic, cell.kind
    cycle = kind.cycle_calls(traffic)
    prof_lo = int(traffic["profile"]["skip"]) if trace else -1
    prof_hi = prof_lo + int(traffic["profile"]["calls"]) if trace else -1
    records, part = [], None
    needed_tokens = needed_flops = 0.0
    probe = box = None
    failures = 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    i = 0
    while i % cycle or i == 0 or time.perf_counter() < deadline or i < prof_hi:
        if i == prof_lo:
            stack = _PartStack(device, program)
            probe, box = stack.enter(forward)
            handed0 = forward.handed
        p = i % len(pool)
        t_a = time.perf_counter()
        try:
            with tr.span(tr.CALL, prof_lo <= i < prof_hi):
                answers = kind.call(program, forward, pool[p], traffic, cfg, device)
        except Exception:  # a failed call is counted and reported, not fatal
            answers = None
            failures += 1
            if failures <= 3:
                log(f"call {i} failed:\n{traceback.format_exc()}")
        seconds_taken = time.perf_counter() - t_a
        records.append({"call": i, "payload": p, "answers": answers, "seconds": seconds_taken,
                        "mutants": kind.mutant_count(pool[p])})
        if prof_lo <= i < prof_hi:
            tokens, flops = kind.needed(pool[p], cfg, cell.family)
            needed_tokens += tokens
            needed_flops += flops
        i += 1
        if i == prof_hi:
            stack.exit(forward)
            part = types.SimpleNamespace(
                trace=tr.parse(box.prof), attn_least_s=probe.least_seconds(),
                handed_tokens=forward.handed - handed0, needed_tokens=needed_tokens,
                needed_flops=needed_flops)
    return records, time.perf_counter() - t_start, part


class _PartStack:
    """Enters and leaves the traced part: the profiler, the attention
    probe and the forward spans."""

    def __init__(self, device, program):
        self.device, self.program = device, program

    def enter(self, forward):
        module, attr, layout = self.program.attention
        self.probe = tr.AttentionProbe(module, attr, layout)
        self.prof_cm = tr.profiled(self.device)
        self.box = self.prof_cm.__enter__()
        self.probe.__enter__()
        forward.spans = True
        return self.probe, self.box

    def exit(self, forward):
        forward.spans = False
        self.probe.__exit__(None, None, None)
        self.prof_cm.__exit__(None, None, None)


def check(cell: Cell, seed: int, records, pool, device: torch.device, control: bool = False):
    """The numbers compared: the sampled answers of the window's calls (or,
    with ``control``, the reference computed one precision lower, put in
    the program's place) against the plain float32 reference, on weights
    drawn again from the seed. Returns ({name: value}, items, seconds)."""
    t0 = time.perf_counter()
    cfg, fam, kind = cell.config, cell.family, cell.kind
    items = kind.sample(records, pool, cell.traffic, seed)
    weights = fam.make_weights(cfg, seed, device)
    ref = kind.reference_answers(items, pool, cfg, fam, fam.Reference(cfg, weights, device), device)
    if control:
        ctrl_ref = fam.Reference(cfg, weights, device, precision=Precision.from_config(cfg, True))
        ctrl = kind.reference_answers(items, pool, cfg, fam, ctrl_ref, device)
        pairs = [(ctrl[it], ref[it]) for it in items]
    else:
        pairs = []
        for r in records:
            for it in items:
                if r["payload"] != it[0]:
                    continue
                got = (None if r["answers"] is None
                       else kind.answer(r["answers"], pool[it[0]], it))
                pairs.append((got, ref[it]))
    worst = 0.0 if pairs else float("inf")
    for got, want in pairs:
        for i, w in enumerate(want):
            gap = float("inf") if got is None else abs(got[i] - w)
            worst = max(worst, gap if math.isfinite(gap) else float("inf"))
    del weights
    return {"max_score_gap": worst}, items, time.perf_counter() - t0


def decide(cell: Cell, numbers, items, failed: int):
    """``correct``, and {name: (value, limit)} of the numbers compared: no
    call failed, the sample is not empty, and every number is within the
    limit that ``checks/<cell>.json`` gives it."""
    checks = {name: (value, cell.limits[name]) for name, value in numbers.items()}
    correct = (failed == 0 and bool(items)
               and all(value <= limit for value, limit in checks.values()))
    return correct, checks


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda", t0=None,
             control: bool = False):
    """One run of ``cell``: set-up, window, reading, check. Returns the
    result object and {name: (value, limit)} of the numbers compared. With
    ``control`` the answers judged are the control's, the reference one
    precision lower put in the program's place (``check``); the benchmark's
    own runs never set it."""
    device = torch.device(device)
    t0 = time.perf_counter() if t0 is None else t0
    pool, program, forward = setup(cell, seed, device)
    if trace and device.type == "cuda":
        with tr.profiled(device):  # CUPTI starts here, not inside the part
            torch.zeros(1, device=device).add_(1)
    setup_s = time.perf_counter() - t0
    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    records, window_s, part = run_window(cell, pool, program, forward, seconds, trace, device)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else None
    failed = sum(r["answers"] is None for r in records)
    log(f"{cell.name} seed {seed}: set-up {setup_s:.3f} s, {len(records)} calls in "
        f"{window_s:.3f} s, {failed} failed")
    cycle = cell.kind.cycle_calls(cell.traffic)
    log("seconds a cycle: " + " ".join(
        f"{sum(r['seconds'] for r in records[c:c + cycle]):.4f}"
        for c in range(0, len(records), cycle)))

    reading = types.SimpleNamespace(
        setup_s=setup_s, records=records, window_s=window_s, window_peak_bytes=window_peak,
        part=part.trace if part else None, attn_least_s=part.attn_least_s if part else None,
        handed_tokens=part.handed_tokens if part else 0,
        needed_tokens=part.needed_tokens if part else 0,
        needed_flops=part.needed_flops if part else 0)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.readers[m["name"]].read(reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    del program, forward
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers, items, check_s = check(cell, seed, records, pool, device, control)
    log(f"checked {len(items)} sampled mutants in {check_s:.3f} s")
    correct, checks = decide(cell, numbers, items, failed)

    result = {"correct": correct, "attempted": len(records), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                         "count": 1,
                         "memory_peak_bytes": (max(setup_peak, window_peak) if cuda else 0)}}
    if trace and part is not None:
        result["device"]["busy_s"] = part.trace.busy_s
        result["device"]["window_s"] = part.trace.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in part.trace.device_ops],
                               "idle_gaps": [list(x) for x in part.trace.idle_gaps]}
        log(f"trace: {part.trace.diagnostics}")
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    import proteingym_tpu_torch

    if ROOT not in Path(proteingym_tpu_torch.__file__).resolve().parents:
        log(f"the port was imported from {proteingym_tpu_torch.__file__}, not from {ROOT}")
        return 2
    log(f"interpreter to torch imported: {_T_TORCH:.3f} s")
    result, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", _T0)
    bad = forbidden_modules()
    if bad:
        log(f"loaded modules of JAX or the JAX package: {bad}")
        return 3
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
