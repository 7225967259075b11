#!/usr/bin/env python3
"""Time the port's attention calls at the main paths' shapes, for one tree.

    python3 tools/torch_attention_ab.py --tree PATH [--tree PATH ...]

Each ``--tree`` is a checkout (or an unpacked ``git archive``) of this
repository; the calls are those of its ``proteingym_tpu_torch`` package,
built from its own sources, so two trees run in turns in one process on
one card compare two versions of the kernels. Every tree is measured once
per round, in the order given and then reversed, ``--rounds`` times (for
trees A and B: A, B, B, A, ...). Needs an NVIDIA GPU.

Calls (bf16, seeded random inputs, each as its model makes it, with the
forward's shared ``KeyTiles`` where the tree has them):

- K4 through ``grouped_mha_bthd`` with ESM's arguments (key mask, RoPE,
  sm_scale 1) at B16 H20 T256 D64 (the L=250 table) and B32 H20 T1024 D64
  (the packed path's window bucket);
- K1 through ``grouped_mha`` with PoET's self-tier arguments (16 segments,
  causal, RoPE, default scale) at B8 H16 T4352 D64;
- K2 through ``mha`` with PoET's multi-tier arguments (causal, each row its
  own valid length, default scale, q/k already rotated) at B8 H16 T4352 D64;
- K3 through ``mha`` with ESM's segment-packed arguments (16 segments of
  ~250 per row, each row its own cuts, the key mask, RoPE, sm_scale 1) at
  B8 H20 T4096 D64;
- K5 through ``num_cluster_members_cuda`` (the sequence-weight neighbour
  counts, identity 0.8) on a seeded synthetic MSA of N=16,384, L=300;
- the float32 K1 through ``grouped_mha`` with the AR zoo's arguments
  (causal, default scale, float32 (B, T, H, D) memory seen as (B, H, T, D))
  at its five shapes: B32 T256 with H16 D256 (ProGen2-xlarge), H16 D128
  (RITA_xl), H20 D64 (ProtGPT2), H24 D96 (ProGen3-3b), and B32 H16 T416
  D128 (RITA_xl's indel bucket).

With ``--e2e``, the paths that run them, with seeded random weights at full
width and depth (host clock, ended by ``torch.cuda.synchronize()``; the
median of as many calls as fill a second, 3 to 50):
ESM2-650M's masked-marginal table of an L=250 sequence (16 forwards of
16 x 256) and its WT-marginal table (one forward of 1 x 252), PoET-200M's
per-token log-probs of 8 rows of 16 context sequences of 250 residues
plus a query (T = 4,282), ESM2-650M's segmented forward of 8 rows of 4,096
tokens packing 16 sequences of 250 tokens each,
``score_assays_packed`` on the six-assay production mix (L = 72 .. 1500,
all single mutants, chunk 32), and, in trees that have it, one
ESM-MSA-1b forward (``esm_msa1b_t12_100M``) of 4 grids of 384 sampled
rows x 241 columns, as the masked-marginal table runs it (path ``MSA``),
and, in trees that have the AR zoo, one forward each of ProtGPT2 and
RITA_xl at their full width and depth on 32 seeded random rows of 256
tokens (paths ``ProtGPT2`` and ``RITA``; float32 K1 in every layer).

Prints one JSON line per tree and round: the card's name and power limit,
the median milliseconds per call (CUDA events around 10 queued calls,
``--samples`` samples), the median host microseconds per call (the host
clock around the same 10 calls as they are queued, no synchronisation
inside: what a host-bound forward waits on), and with ``--e2e`` the median
seconds of each path (``seconds``: the host clock to the synchronise),
with its device time (``device_s``: CUDA events around the call) and its
host time (``host_s``: the host clock until the call returns, before the
synchronise: what it takes to queue the work).
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
    esm_scoring, packed_scoring, poet, weights and, where the tree has it,
    msa_transformer, as a dict."""
    for name in [m for m in sys.modules if m.startswith("proteingym_tpu_torch")]:
        del sys.modules[name]
    names = ["ops.flash_attention", "models.esm2", "models.esm_scoring",
             "models.packed_scoring", "models.poet", "msa.weights"]
    for name in ("msa_transformer", "ar_zoo"):
        if (tree / "proteingym_tpu_torch" / "models" / f"{name}.py").exists():
            names.append(f"models.{name}")
    sys.path.insert(0, str(tree))
    try:
        mods = {name.rsplit(".", 1)[-1]: importlib.import_module(f"proteingym_tpu_torch.{name}")
                for name in names}
        # build and load now: the wrappers import _build lazily, and a
        # later tree's package will have replaced it in sys.modules
        # (trees before the loop took K2 and K3 have a library for each)
        for lib in ("_kernel_lib", "_seg_block_lib", "_flash_lib"):
            if hasattr(mods["flash_attention"], lib):
                getattr(mods["flash_attention"], lib)()
        mods["weights"]._kernel_lib()
    finally:
        sys.path.pop(0)
    for mod in mods.values():
        if not Path(mod.__file__).resolve().is_relative_to(tree.resolve()):
            raise SystemExit(f"imported {mod.__file__}, not the port in {tree}")
    return mods


def calls(torch, mods, dev):
    fa, weights = mods["flash_attention"], mods["weights"]
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

    mask = lengths_mask(b, t, [t - 7 * i for i in range(b)])
    k2_tiles = fa.KeyTiles(key_mask=mask, causal=True)
    out[f"K2 B{b} H{h} T{t} D64 causal+mask"] = lambda: fa.mha(
        q, k, v, key_mask=mask, causal=True, key_tiles=k2_tiles)

    b, h, t = 8, 20, 4096
    seg3 = torch.zeros(b, t, dtype=torch.int32, device=dev)
    for i in range(b):  # 16 segments of ~250, each row its own cuts, then padding
        ends = np.cumsum(250 + rs.randint(-20, 6, 16))
        for s_id, (lo, hi) in enumerate(zip([0, *ends[:-1]], ends), start=1):
            seg3[i, lo:hi] = s_id
    mask3 = seg3 > 0
    k3_tiles = fa.KeyTiles(seg3, mask3)
    q3, k3, v3 = (x.transpose(1, 2) for x in bthd(b, h, t))
    out[f"K3 B{b} H{h} T{t} D64 16x~250+mask+rope"] = lambda: fa.mha(
        q3, k3, v3, key_mask=mask3, sm_scale=1.0, rope_base=10000.0, segment_ids=seg3,
        key_tiles=k3_tiles)

    n, length = 16384, 300  # a family of n // 16 centres, 0-15% substitutions, ~5% gaps
    centres = rs.randint(1, 21, (n // 16, length))
    msa = centres[rs.randint(0, n // 16, n)]
    sub = rs.rand(n, length) < rs.uniform(0.0, 0.15, (n, 1))
    msa[sub] = rs.randint(1, 21, sub.sum())
    msa[rs.rand(n, length) < 0.05] = 0
    msa = torch.from_numpy(msa.astype(np.int8)).to(dev)
    out[f"K5 N{n} L{length}"] = lambda: weights.num_cluster_members_cuda(msa, 0.8)

    for b, h, t, d in ZOO_K1:
        qf, kf, vf = (torch.randn(b, t, h, d, generator=gen, device=dev).transpose(1, 2)
                      for _ in range(3))
        out[f"K1 f32 B{b} H{h} T{t} D{d} causal"] = (
            lambda q=qf, k=kf, v=vf: fa.grouped_mha(q, k, v, causal=True))
    return out


# (B, H, T, D) of the float32 K1 on the AR zoo's paths (chip_smoke.K1_ZOO)
ZOO_K1 = ((32, 16, 256, 256), (32, 16, 256, 128), (32, 20, 256, 64), (32, 24, 256, 96),
          (32, 16, 416, 128))


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
    seg_fn = esm2.make_segmented_apply_fn(model)
    packed_tok = torch.full((8, 4096), esm2.ALPHABET.padding_idx, dtype=torch.long)
    packed_seg = torch.zeros(8, 4096, dtype=torch.int32)
    for r in range(8):  # 16 sequences of 248 residues (250 tokens) per row
        for s_id in range(16):
            toks = esm2.ALPHABET.tokenize(synth_seq(rs, 248))
            packed_tok[r, 250 * s_id:250 * (s_id + 1)] = torch.from_numpy(toks.astype(np.int64))
            packed_seg[r, 250 * s_id:250 * (s_id + 1)] = s_id + 1
    packed_tok, packed_seg = packed_tok.to(dev), packed_seg.to(dev)
    out = {}
    if "msa_transformer" in mods:
        mt = mods["msa_transformer"]
        mmodel = mt.init_random(mt.PRESETS["esm_msa1b_t12_100M"], seed=0, device=dev)
        focus = rs.randint(0, 20, 240)
        rows = np.tile(focus, (384, 1))
        sub = rs.rand(384, 240) < 0.3  # a family: 30% of each row substituted
        rows[sub] = rs.randint(0, 20, int(sub.sum()))
        msa_tok = torch.as_tensor(mt.tokenize_msa(["".join(AA[c] for c in r) for r in rows]),
                                  dtype=torch.long, device=dev)
        grids = msa_tok.expand(4, -1, -1).clone()
        grids[torch.arange(4), 0, torch.arange(1, 5)] = mt.ALPHABET.mask_idx
        out[f"MSA forward 4 x 384 x {grids.shape[2]}"] = lambda: mmodel(
            grids, query_row_only=True)
    if "ar_zoo" in mods:
        zoo = mods["ar_zoo"]
        gpt2 = zoo.gpt2_init(zoo.Gpt2Config(), seed=0, device=dev)
        rita = zoo.rita_init(zoo.RITA_PRESETS["RITA_xl"], seed=0, device=dev)
        gpt2_tok = torch.from_numpy(rs.randint(0, gpt2.config.vocab_size, (32, 256))).to(dev)
        rita_tok = torch.from_numpy(rs.randint(0, rita.config.vocab_size, (32, 256))).to(dev)
        out["ProtGPT2 forward 32 x 256"] = lambda: gpt2(gpt2_tok)
        out["RITA_xl forward 32 x 256"] = lambda: rita(rita_tok)
    return {
        "ESM2-650M masked table L=250": lambda: esm_scoring.masked_marginal_table(
            model, tokens, chunk=16, window=config.max_positions, pad_to_multiple=64),
        "ESM2-650M WT table L=250": lambda: esm_scoring.wt_marginal_table_overlapping(
            model, tokens, window=config.max_positions),
        f"PoET-200M log-probs 8 x {tok.shape[1]}": lambda: poet.token_logprobs(
            pmodel, tok, seg, pos, val),
        "ESM2-650M segment-packed forward 8 x 4096": lambda: seg_fn(packed_tok, packed_seg),
        "score_assays_packed production mix": lambda: packed.score_assays_packed(
            model, assays, chunk=32, window=config.max_positions),
        **out,
    }


def time_s(torch, fn, seconds=1.0):
    """Median seconds of one call, over as many calls as fill ``seconds``
    (at least 3, at most 50): a ~15 ms host-bound path needs dozens.
    Returns (wall, device, host): the host clock to the synchronise, CUDA
    events around the call, the host clock until the call returns."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = min(50, max(3, round(seconds / (time.perf_counter() - t0))))
    wall, device, host = [], [], []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        device.append(start.elapsed_time(end) / 1e3)
    return tuple(statistics.median(x) for x in (wall, device, host))


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
    fns = {tree: calls(torch, mods, dev) for tree, mods in ports.items()}
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
                    t = {name: time_s(torch, fn) for name, fn in e2e[tree].items()}
                for key, i in (("seconds", 0), ("device_s", 1), ("host_s", 2)):
                    line[key] = {name: v[i] for name, v in t.items()}
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
