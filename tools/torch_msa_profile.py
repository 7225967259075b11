#!/usr/bin/env python3
"""Where the time of one ESM-MSA-1b forward goes, on one NVIDIA GPU.

    python3 tools/torch_msa_profile.py [--grids 4] [--rows 384] [--cols 241]

One forward of ``esm_msa1b_t12_100M`` (seeded random bf16 weights, full
width and depth) on ``--grids`` copies of a seeded synthetic alignment of
``--rows`` rows x ``--cols`` columns ([CLS] included), one first-row
column masked in each, as the masked-marginal table runs it (the LM head on
row 0 only):

- the whole forward: the host clock to the synchronise and CUDA events
  (median of 5), and the device's idle share (1 - the kernels' summed
  device time / the forward's wall, from ``torch.profiler``);
- the device time by kernel (``torch.profiler``, one forward), the 15
  largest;
- each block of one layer alone on the same activations (CUDA events,
  median of 5): the tied row attention, the column attention (K1 inside)
  and the FFN, each with its layer norm and residual, and the column
  attention's K1 call alone at its shape;
- the row attention's score product at its shape, (B*H, C, R*D) by its
  transpose, three ways: bf16 in and float32 out (``torch.bmm(...,
  out_dtype=torch.float32)``, the model's route), float32 of the widened
  operands, and bf16 out, each timed (median of 5) with its largest
  difference from the float32 product.

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

AA = "ACDEFGHIKLMNPQRSTVWY"


def events_ms(torch, fn, reps=5):
    """Median device milliseconds of one call (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grids", type=int, default=4)
    ap.add_argument("--rows", type=int, default=384)
    ap.add_argument("--cols", type=int, default=241)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from proteingym_tpu_torch.models import msa_transformer as mt
    from proteingym_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("torch sees no CUDA device; this script times the card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    config = mt.PRESETS["esm_msa1b_t12_100M"]
    model = mt.init_random(config, seed=0, device=dev)
    rs = np.random.RandomState(0)
    rows = np.tile(rs.randint(0, 20, args.cols - 1), (args.rows, 1))
    sub = rs.rand(*rows.shape) < 0.3
    rows[sub] = rs.randint(0, 20, int(sub.sum()))
    tokens = torch.as_tensor(mt.tokenize_msa(["".join(AA[c] for c in r) for r in rows]),
                             dtype=torch.long, device=dev)
    b = args.grids
    grids = tokens.expand(b, -1, -1).clone()
    grids[torch.arange(b), 0, torch.arange(1, b + 1)] = mt.ALPHABET.mask_idx

    def forward():
        with torch.no_grad():
            return model(grids, query_row_only=True)

    ms = events_ms(torch, forward)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    kernels = [e for e in prof.key_averages() if e.device_time_total > 0]
    busy = sum(e.device_time_total for e in kernels) / 1e3
    print(f"forward {b} x {args.rows} x {args.cols}: wall {wall * 1e3:.1f} ms, device "
          f"{ms:.1f} ms (medians of 5); profiled: wall {prof_wall * 1e3:.1f} ms, kernels "
          f"{busy:.1f} ms, idle share {1 - busy / (prof_wall * 1e3):.3f}; peak {peak:.2f} GiB")
    print("device ms by kernel (one forward):")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:15]:
        print(f"  {e.device_time_total / 1e3:9.3f} {100 * e.device_time_total / 1e3 / busy:5.1f}%"
              f"  x{e.count:<4d} {e.key[:90]}")

    layer = model.layers[0]
    with torch.no_grad():
        x = model.embed_tokens(grids)
        pad_mask = grids == mt.ALPHABET.padding_idx
        key_mask = (~pad_mask).transpose(1, 2).reshape(-1, args.rows)
        blocks = {
            "row attention block": lambda: layer.row_self_attention(x, pad_mask, pad_mask[:, 0]),
            "column attention block": lambda: layer.column_self_attention(x, key_mask),
            "FFN block": lambda: layer.feed_forward_layer(x),
        }
        h, d = config.num_heads, config.head_dim
        q, k, v = (torch.randn(b * args.cols, args.rows, h, d, device=dev, dtype=torch.bfloat16)
                   .transpose(1, 2) for _ in range(3))
        blocks["K1 call alone"] = lambda: fa.grouped_mha(q, k, v, key_mask=key_mask, sm_scale=1.0)
        print("one layer's blocks alone (device ms, median of 5; x12 layers in the forward):")
        for name, fn in blocks.items():
            t = events_ms(torch, fn)
            print(f"  {name:<24s} {t:8.3f} ms  x12 = {12 * t:8.1f} ms ({100 * 12 * t / ms:.1f}%)")
        del q, k, v
        qs, ks = (torch.randn(b * h, args.cols, args.rows * d, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        kt = ks.transpose(1, 2)
        exact = torch.bmm(qs.float(), kt.float())
        routes = {
            "bf16 in, float32 out": lambda: torch.bmm(qs, kt, out_dtype=torch.float32),
            "float32 of widened operands": lambda: torch.bmm(qs.float(), kt.float()),
            "bf16 out": lambda: torch.bmm(qs, kt),
        }
        print(f"row attention scores ({b * h}, {args.cols}, {args.rows * d}) x its transpose, "
              f"|scores| up to {float(exact.abs().max()):.1f}:")
        for name, fn in routes.items():
            err = float((fn().float() - exact).abs().max())
            print(f"  {name:<28s} {events_ms(torch, fn):8.3f} ms  max diff from float32 {err:.4g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
