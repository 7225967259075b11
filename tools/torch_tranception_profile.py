#!/usr/bin/env python3
"""Where the time of one Tranception-L forward and of the EVE prior goes, on
one NVIDIA GPU.

    python3 tools/torch_tranception_profile.py [--batch 32] [--tokens 256 1024]

For each ``--tokens`` T: one forward of Tranception-L (seeded random bf16
weights, full width and depth) on ``--batch`` rows of T tokens, each row
[CLS] + residues + [SEP] with its own pad tail (as the AR harness's
length buckets hand them):

- the forward's wall (host clock to the synchronise) and device time (CUDA
  events), medians of 5, and the idle share (1 - the kernels' summed
  device time / the wall of the profiled forward, ``torch.profiler``);
- the device time by kind: K1 (the Hopper loop), the dense GEMMs, the
  depthwise convolutions, and the elementwise passes (layer norms, the
  squared ReLU, casts, copies, residual adds, the log-softmax), each with
  its share and launch count, then the 12 largest kernels by name.

Then one step of the EVE prior at EVE's default architecture over 240
columns: ``retrieval.DRAWS_PER_STEP`` decoder draws (noise, the weight
samples, the output convolution product, the log-softmax), device ms per
draw.

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
KINDS = (  # (kind, substrings of the kernel name), first match wins
    ("K1 (Hopper loop)", ("hopper_attention", "grouped_attention")),
    ("GEMM", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
    ("depthwise conv", ("conv", "cudnn")),
)


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


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "elementwise and other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--tokens", type=int, nargs="+", default=[256, 1024])
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from proteingym_tpu_torch.models import eve, retrieval, tranception
    from proteingym_tpu_torch.pipeline.checkpoints import load_tranception_checkpoint

    if not torch.cuda.is_available():
        raise SystemExit("torch sees no CUDA device; this script times the card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    model, config = load_tranception_checkpoint("Large", device=dev)  # the CLI's weights
    rs = np.random.RandomState(0)
    for t in args.tokens:
        rows = [tranception.VOCAB.tokenize("".join(rs.choice(list(AA), t - 2 - rs.randint(0, 8))),
                                           pad_to=t) for _ in range(args.batch)]
        tokens = torch.from_numpy(np.stack(rows)).long().to(dev)

        def forward():
            with torch.no_grad():
                return torch.log_softmax(model(tokens), -1)

        ms = events_ms(torch, forward)
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        kernels = [e for e in prof.key_averages() if e.device_time_total > 0]
        busy = sum(e.device_time_total for e in kernels) / 1e3
        print(f"Tranception-L forward {args.batch} x {t}: wall {statistics.median(walls) * 1e3:.2f}"
              f" ms, device {ms:.2f} ms (medians of 5); profiled: wall {prof_wall:.2f} ms, "
              f"kernels {busy:.2f} ms, idle share {1 - busy / prof_wall:.3f}; peak {peak:.2f} GiB")
        by_kind = {}
        for e in kernels:
            ms_k, n = by_kind.get(kind_of(e.key), (0.0, 0))
            by_kind[kind_of(e.key)] = (ms_k + e.device_time_total / 1e3, n + e.count)
        for kind, (ms_k, n) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
            print(f"  {kind:<22s} {ms_k:9.3f} ms {100 * ms_k / busy:5.1f}%  {n} launches")
        print("  largest kernels:")
        for e in sorted(kernels, key=lambda e: -e.device_time_total)[:12]:
            print(f"    {e.device_time_total / 1e3:9.3f} {100 * e.device_time_total / 1e3 / busy:5.1f}%"
                  f"  x{e.count:<4d} {e.key[:120]}")
    del model
    torch.cuda.empty_cache()

    eve_model = eve.init_random(eve.EveConfig(seq_len=240), seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    draws = retrieval.DRAWS_PER_STEP
    x = torch.from_numpy(eve.onehot_sequence("".join(rs.choice(list(AA), 240)))[None]).to(dev)
    with torch.no_grad():
        mu, logvar = eve_model.encode(x)
        z = mu + torch.exp(0.5 * logvar) * torch.randn((draws, *mu.shape), generator=gen,
                                                        device=dev)
        step = events_ms(torch, lambda: eve_model.decode(z, generator=gen).sum(dim=(0, 1)))
    n_weights = sum(m.numel() for m, _ in eve_model.variational())
    print(f"EVE prior, default architecture over 240 columns: {draws} draws per "
          f"step {step:.3f} ms -> {step / draws:.4f} ms per draw "
          f"({n_weights / 1e6:.1f}M sampled weights per draw)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
