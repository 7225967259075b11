#!/usr/bin/env python3
"""Readings that a cell's limits are set from, on the card at the cell's
own size, many seeds in one process:

    python3 h100bench/calibrate.py --workload <cell> --seeds 1,2,3 --calls <n> [--control <k>]

For each seed: set-up as a run has it, ``--calls`` calls of the cell's
traffic (its longest requests among them), then the numbers compared of
the program against the plain reference on the run's sample, and for the
first ``--control`` seeds the same numbers of the control: the reference
one precision below the configuration's (``control`` in its file), put
in the program's place. One JSON line per seed. The benchmark's runs do
not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from h100bench import run  # noqa: E402
from h100bench.bench import load_cell  # noqa: E402
from h100bench.guard import forbidden_modules  # noqa: E402


def readings(cell, seed: int, calls: int, control: bool, device) -> dict:
    t0 = time.perf_counter()
    pool, program, forward = run.setup(cell, seed, device)
    records = []
    for i in range(calls):
        p = i % len(pool)
        answers = cell.kind.call(program, forward, pool[p], cell.traffic, cell.config, device)
        records.append({"call": i, "payload": p, "answers": answers, "seconds": 0.0,
                        "mutants": cell.kind.mutant_count(pool[p])})
    del program, forward
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "calls": calls}
    numbers, items, _ = run.check(cell, seed, records, pool, device)
    out.update(n_items=len(items), program=numbers,
               program_correct=run.decide(cell, numbers, items, 0)[0])
    if control:
        numbers, items, _ = run.check(cell, seed, records, pool, device, control=True)
        out.update(control=numbers, control_correct=run.decide(cell, numbers, items, 0)[0])
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--calls", type=int, required=True)
    ap.add_argument("--control", type=int, default=0,
                    help="read the control on the first this many seeds")
    args = ap.parse_args(argv)
    cell = load_cell(ROOT, args.workload)
    device = torch.device("cuda")
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, args.calls, n < args.control, device)), flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
