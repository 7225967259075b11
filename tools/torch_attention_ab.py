#!/usr/bin/env python3
"""Time the port's attention calls at the main paths' shapes, for one tree.

    python3 tools/torch_attention_ab.py --tree PATH [--tree PATH ...]

Each ``--tree`` is a checkout (or an unpacked ``git archive``) of this
repository; the calls are those of its ``proteingym_tpu_torch`` package,
built from its own sources, so two trees run in turns in one process on
one card compare two versions of the kernels. Every tree is measured once
per round, in the order given and then reversed, ``--rounds`` times (for
trees A and B: A, B, B, A, ...). Needs an NVIDIA GPU.

Calls (bf16, seeded random inputs, each as its model makes it):

- K4 through ``grouped_mha_bthd`` with ESM's arguments (key mask, RoPE,
  sm_scale 1) at B16 H20 T256 D64 (the L=250 table) and B32 H20 T1024 D64
  (the packed path's window bucket);
- K1 through ``grouped_mha`` with PoET's self-tier arguments (16 segments,
  causal, RoPE, default scale, and the forward's shared ``KeyTiles`` where
  the tree has them) at B8 H16 T4352 D64;
- K3 through ``seg_block_mha`` at B8 H20 T4096 D64, 16 segments of 250 (the
  segment-packed rows), as a control.

With ``--e2e``, the paths that run them, with seeded random weights at full
width and depth (host clock, ended by ``torch.cuda.synchronize()``; the
median of as many calls as fill a second, 3 to 50):
ESM2-650M's masked-marginal table of an L=250 sequence (16 forwards of
16 x 256) and its WT-marginal table (one forward of 1 x 252), PoET-200M's
per-token log-probs of 8 rows of 16 context sequences of 250 residues
plus a query (T = 4,282), and ``score_assays_packed`` on the six-assay
production mix (L = 72 .. 1500, all single mutants, chunk 32).

Prints one JSON line per tree and round: the card's name and power limit,
the median milliseconds per call (CUDA events around 10 queued calls,
``--samples`` samples), the median host microseconds per call (the host
clock around the same 10 calls as they are queued, no synchronisation
inside: what a host-bound forward waits on), and with ``--e2e`` the median
seconds of each path.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def load_port(tree: Path):
    """The port's modules in ``tree`` (built there): flash_attention, esm2,
    esm_scoring, packed_scoring and poet, as a dict."""
    for name in [m for m in sys.modules if m.startswith("proteingym_tpu_torch")]:
        del sys.modules[name]
    sys.path.insert(0, str(tree))
    try:
        mods = {name.rsplit(".", 1)[-1]: importlib.import_module(f"proteingym_tpu_torch.{name}")
                for name in ("ops.flash_attention", "models.esm2", "models.esm_scoring",
                             "models.packed_scoring", "models.poet")}
        # build and load now: the wrappers import _build lazily, and a
        # later tree's package will have replaced it in sys.modules
        for lib in ("_kernel_lib", "_seg_block_lib", "_flash_lib"):
            getattr(mods["flash_attention"], lib)()
    finally:
        sys.path.pop(0)
    for mod in mods.values():
        if not Path(mod.__file__).resolve().is_relative_to(tree.resolve()):
            raise SystemExit(f"imported {mod.__file__}, not the port in {tree}")
    return mods


def calls(torch, fa, dev):
    gen = torch.Generator(device=dev).manual_seed(0)

    def bthd(b, h, t, d=64):
        return [torch.randn(b, t, h, d, generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(3)]

    def lengths_mask(b, t, lengths):
        return torch.arange(t, device=dev)[None] < torch.tensor(lengths, device=dev)[:, None]

    out = {}
    for b, h, t in ((16, 20, 256), (32, 20, 1024)):
        q, k, v = bthd(b, h, t)
        mask = lengths_mask(b, t, [t - 4 - 3 * i for i in range(b)])
        out[f"K4 B{b} H{h} T{t} D64 mask+rope"] = (
            lambda q=q, k=k, v=v, mask=mask: fa.grouped_mha_bthd(
                q, k, v, key_mask=mask, sm_scale=1.0, rope_base=10000.0))

    b, h, t = 8, 16, 4352
    seg = torch.zeros(b, t, dtype=torch.int32, device=dev)
    rs = np.random.RandomState(b)
    for i in range(b):  # 16 ragged segments, then 40 padding tokens
        cuts = np.sort(rs.choice(np.arange(100, t - 140), 15, replace=False))
        for s_id, (lo, hi) in enumerate(zip([0, *cuts], [*cuts, t - 40]), start=1):
            seg[i, lo:hi] = s_id
    q, k, v = (x.transpose(1, 2) for x in bthd(b, h, t))
    tiles = {"key_tiles": fa.KeyTiles(seg, causal=True)} if hasattr(fa, "KeyTiles") else {}
    out[f"K1 B{b} H{h} T{t} D64 16 segments+causal+rope"] = lambda: fa.grouped_mha(
        q, k, v, segment_ids=seg, causal=True, rope_base=10000.0, **tiles)

    b, h, t = 8, 20, 4096
    seg3 = torch.zeros(b, t, dtype=torch.int32, device=dev)
    for i in range(16):
        seg3[:, 250 * i:250 * (i + 1)] = i + 1
    q3, k3, v3 = (x.transpose(1, 2) for x in bthd(b, h, t))
    out[f"K3 B{b} H{h} T{t} D64 16x250+rope"] = lambda: fa.seg_block_mha(
        q3, k3, v3, seg3, sm_scale=1.0, rope_base=10000.0)
    return out


AA = "ACDEFGHIKLMNPQRSTVWY"
PACKED_MIX = (72, 118, 250, 448, 709, 1500)


def synth_seq(rs, length):
    return "".join(AA[i] for i in rs.randint(0, 20, length))


def paths(torch, mods, dev):
    """The end-to-end calls of --e2e, each a no-argument function."""
    esm2, esm_scoring = mods["esm2"], mods["esm_scoring"]
    packed, poet = mods["packed_scoring"], mods["poet"]
    rs = np.random.RandomState(0)
    config = esm2.PRESETS["esm2_t33_650M"]
    model = esm2.init_random(config, seed=0, device=dev)
    tokens = esm2.ALPHABET.tokenize(synth_seq(rs, 250))
    assays = []
    for length in PACKED_MIX:
        seq = synth_seq(rs, length)
        assays.append((seq, [f"{seq[i]}{i + 1}{a}" for i in range(length) for a in AA
                             if a != seq[i]]))
    pconfig = poet.POET_PRESETS["poet_200m"]
    pmodel = poet.init_random(pconfig, seed=0, device=dev)
    ctx = [synth_seq(rs, 250) for _ in range(16)]
    rows = poet.build_rows(ctx, [synth_seq(rs, 250) for _ in range(8)])
    tok, seg, pos, val = (torch.from_numpy(a).to(dev) for a in rows[:4])
    return {
        "ESM2-650M masked table L=250": lambda: esm_scoring.masked_marginal_table(
            model, tokens, chunk=16, window=config.max_positions, pad_to_multiple=64),
        "ESM2-650M WT table L=250": lambda: esm_scoring.wt_marginal_table_overlapping(
            model, tokens, window=config.max_positions),
        f"PoET-200M log-probs 8 x {tok.shape[1]}": lambda: poet.token_logprobs(
            pmodel, tok, seg, pos, val),
        "score_assays_packed production mix": lambda: packed.score_assays_packed(
            model, assays, chunk=32, window=config.max_positions),
    }


def time_s(torch, fn, seconds=1.0):
    """Median seconds of one call, over as many calls as fill ``seconds``
    (at least 3, at most 50): a ~15 ms host-bound path needs dozens."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = min(50, max(3, round(seconds / (time.perf_counter() - t0))))
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def time_ms(torch, fn, samples, inner=10):
    """Median device milliseconds and host microseconds per call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    device, host = [], []
    for _ in range(samples):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        host.append((time.perf_counter() - t0) / inner * 1e6)
        end.record()
        torch.cuda.synchronize()
        device.append(start.elapsed_time(end) / inner)
    return statistics.median(device), statistics.median(host)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--samples", type=int, default=10)
    ap.add_argument("--e2e", action="store_true", help="also time the paths end to end")
    ap.add_argument("--only", default="", help="with --e2e, time only the paths whose "
                    "names contain one of these comma-separated words")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch sees no CUDA device; this script times the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    ports = {tree: load_port(tree) for tree in args.tree}  # builds each tree's kernels
    fns = {tree: calls(torch, mods["flash_attention"], dev) for tree, mods in ports.items()}
    e2e = {tree: paths(torch, mods, dev) for tree, mods in ports.items()} if args.e2e else {}
    words = [w for w in args.only.split(",") if w]
    e2e = {tree: {name: fn for name, fn in fns_.items()
                  if not words or any(w in name for w in words)}
           for tree, fns_ in e2e.items()}
    for r in range(args.rounds):
        for tree in (args.tree if r % 2 == 0 else args.tree[::-1]):
            times = {name: time_ms(torch, fn, args.samples) for name, fn in fns[tree].items()}
            line = {"tree": str(tree), "round": r, "card": card,
                    "ms": {name: t[0] for name, t in times.items()},
                    "host_us": {name: t[1] for name, t in times.items()}}
            if args.e2e:
                with torch.no_grad():
                    line["seconds"] = {name: time_s(torch, fn) for name, fn in e2e[tree].items()}
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
