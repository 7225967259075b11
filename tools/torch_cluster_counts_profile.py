#!/usr/bin/env python3
"""Where the time of one sequence-weight call (K5) goes, on one NVIDIA GPU.

    python3 tools/torch_cluster_counts_profile.py [--shapes 16384x300,8192x1000]

For each (N, L), on a seeded synthetic family (N // 16 cluster centres,
0-15% substitutions and gap or code-21 noise):

- the device time of one ``num_cluster_members_cuda`` call by kernel
  (``torch.profiler``, the mean of 3 calls): the Gram kernel, the one-hot
  pre-pass and the wrapper's torch ops;
- the whole call by CUDA events (median, min and max of 7 samples of 5
  queued calls);
- the host time of one call (until it returns, the card idle before it),
  at N itself and at 9 other N just below it, each seen for the first time
  in the process: what ``pgym weights`` pays once per MSA;
- at the first shape, cuBLAS's int8 Gram of the full square on the same
  one-hot (``torch._int_mm``), which is not K5's function.

Prints the card's name and power limit first. Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def family(n, length, seed):
    rng = np.random.default_rng(seed)
    centres = rng.integers(1, 21, (max(1, n // 16), length))
    m = centres[rng.integers(0, len(centres), n)]
    sub = rng.random((n, length)) < rng.uniform(0.0, 0.15, (n, 1))
    m[sub] = rng.integers(0, 22, sub.sum())
    return m.astype(np.int8)


def time_ms(torch, fn, reps=7, inner=5):
    """(median, min, max) device milliseconds per call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / inner)
    return statistics.median(out), min(out), max(out)


def host_us(torch, fn):
    """Microseconds until ``fn`` returns, the queue drained before it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    t = (time.perf_counter() - t0) * 1e6
    torch.cuda.synchronize()
    return t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default="16384x300,8192x1000,65536x300")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from proteingym_tpu_torch.msa import weights as W

    if not torch.cuda.is_available():
        raise SystemExit("torch sees no CUDA device; this script times the card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    for idx, shape in enumerate(args.shapes.split(",")):
        n, length = (int(x) for x in shape.split("x"))
        m = torch.from_numpy(family(n, length, 5)).to(dev)
        W.num_cluster_members_cuda(m, 0.8)  # builds the library at the first shape
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                W.num_cluster_members_cuda(m, 0.8)
            torch.cuda.synchronize()
        print(f"== N={n} L={length}: device ms per call by kernel (mean of 3 calls)")
        events = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
        for ev in events[:12]:
            print(f"   {ev.device_time_total / 3 / 1e3:9.4f}  x{ev.count // 3:<2d} {ev.key[:80]}")
        t = time_ms(torch, lambda: W.num_cluster_members_cuda(m, 0.8))
        print(f"   whole call {t[0]:.4f} ms [{t[1]:.4f}-{t[2]:.4f}]", flush=True)

        same_n = [host_us(torch, lambda: W.num_cluster_members_cuda(m, 0.8)) for _ in range(9)]
        new_n = [host_us(torch, lambda: W.num_cluster_members_cuda(m[:n - k], 0.8))
                 for k in range(1, 10)]
        print(f"   host us per call: at N again {statistics.median(same_n):.1f} "
              f"[{min(same_n):.1f}-{max(same_n):.1f}], at a new N (N-1 .. N-9) "
              f"{statistics.median(new_n):.1f} [{min(new_n):.1f}-{max(new_n):.1f}]", flush=True)
        if idx == 0:
            onehot = W.one_hot_nogap(m.to(torch.int32))
            t = time_ms(torch, lambda: torch._int_mm(onehot, onehot.t()))
            print(f"   torch._int_mm(onehot, onehot.T), the full square, not K5's function: "
                  f"{t[0]:.4f} ms [{t[1]:.4f}-{t[2]:.4f}], "
                  f"{2 * n * n * onehot.shape[1] / t[0] / 1e9:.1f} TOP/s", flush=True)
            del onehot
        del m
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
