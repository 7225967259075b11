#!/usr/bin/env python3
"""Drive the PyTorch port once on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure raises, and the script exits non-zero):

1. device: the card's name and power limit (nvidia-smi), torch/CUDA
   versions; TF32 is switched off for matmuls and cuDNN.
2. build: nvcc builds the four kernel sources from ops/csrc, one process
   per source, all started together.
3. kernel: the grouped attention kernel (K1, bf16 on the Hopper loop after
   the rope_qk pre-pass) against the plain PyTorch version on the card, in
   every mode the slices use and at every head dim, and both timed at the
   ESM2-650M headline shape.
4. slice: ``score --model esm --checkpoint esm2_t33_650M`` (seeded random
   bf16 weights, full width and depth) on a synthetic L=250 assay with all
   4,750 single mutants, through the port's CLI; the launch counter must
   show 33 launches of the heads-mid entry (K4) per chunk forward; the
   whole log-prob table is recomputed with the plain attention and
   compared.
5. windowed: ``esm2_t6_8M`` on an L=1100 assay, through the CLI, so every
   row takes the optimal-window path at T=1024.
6. cluster counts (K5): the sequence-weight kernel against its plain
   version, counts equal exactly, on ragged alignments with all-gap and
   duplicated rows, then on a seeded synthetic MSA at N=16,384, L=300;
   both timed there.
7. long-context attention (K2): against the plain version in bf16 and
   float32 (causal + mask at T=2048 and 4352, ALiBi + causal, ragged T,
   fully masked rows); K1 at PoET's self-tier shape (segmented + causal +
   RoPE, T=4352), at B1 and at B8 with each row's own cuts (the timed
   call, held on live rows); K2 and K1 timed at PoET's row shape, each
   beside the PyTorch call that computes the same function
   (scaled_dot_product_attention with a dense boolean mask) and its bound.
8. PoET slice: ``weights`` then ``score --model poet --checkpoint
   poet_200m`` (seeded random bf16 weights, full width and depth) through
   the port's CLI, on a synthetic L=250 assay (128 single mutants) with a
   16,384-sequence MSA: the weights file is written by K5 and reused, each
   forward launches K1 and K2 12 times each, two queries' per-token
   log-probs are recomputed with the plain attention and compared.
9. K3 and K4: the extent-sparse segmented kernel and the heads-mid entry
   against their plain versions in bf16 and float32 (live query rows);
   K3 timed against its plain version and K1's segmented mode at B8 H20
   T4096 with 16 segments of 250 tokens, K4 against its plain version at
   the headline shape and at the packed path's window bucket (B32 H20
   T1024), and the rope_qk pre-pass at the latter (equal to its plain
   version bit for bit); each beside
   scaled_dot_product_attention on the same pre-rotated q/k and its bound.
10. packed: ``score --model esm --checkpoint esm2_t33_650M --packed``
   through the CLI on synthetic assays of lengths 72, 118, 250, 448, 709
   and 1500 with all single mutants, twice (the second run is timed): 33
   K4 launches per forward; the L=250 scores equal phase 4's per-assay
   scores.
11. segment-packed: ``score_assays_packed(..., seg_apply_fn=...,
   row_len=4096)`` with ESM2-650M on the assays up to L=709, twice: 33 K3
   launches per forward and no K1 launch; scores equal phase 10's; two
   packed rows' log-probs recomputed with the plain attention.
12. the benchmark flow, ESM2-650M: (a) ``score --extra
   scoring_strategy=wt-marginals`` on phase 4's L=250 assay and on an
   L=3000 assay (five overlapping windows in one forward), 33 K4 launches
   each, tables against the plain attention; (b) ``pseudo-ppl`` on 16
   mutants of the L=250 assay, 33 x 17 x 16 K4 launches, the WT's and one
   mutant's masked tables against the plain attention; (c) ``merge`` then
   ``evaluate --device cuda`` of the three ESM score files; (d) ``merge``
   and ``evaluate`` of 217 synthetic assays x 2,000 mutants x 10 models,
   bootstrap 10,000, on the card and on the CPU: every CSV equal at 1e-9,
   the ranking in noise order, Spearman and AUC on the card against scipy;
   (e) ``evaluate-clinical --device cuda``.

Every phase holds the port to its rule: no module of the JAX package
(``proteingym_tpu``) may be loaded. It prints one JSON line describing the
kernels (time, plain version, the PyTorch call for the same function where
there is one, the bound: the larger of bytes over 3.35 TB/s and operations
over 989 TFLOP/s, the H100 SXM's peaks), then, as its last line,
``{"ok": true, "device": {...}}``. With no CUDA device, or outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import csv
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np

REPO = Path(__file__).resolve().parent
AA = "ACDEFGHIKLMNPQRSTVWY"
KERNELS = {  # launch counter -> (source, the TPU kernel it replaces)
    "grouped_attention": ("proteingym_tpu_torch/ops/csrc/grouped_attention.cu",
                          "proteingym_tpu/ops/flash_attention.py:181"),
    "flash_attention": ("proteingym_tpu_torch/ops/csrc/flash_attention.cu",
                        "proteingym_tpu/ops/flash_attention.py:48"),
    "seg_block_attention": ("proteingym_tpu_torch/ops/csrc/seg_block_attention.cu",
                            "proteingym_tpu/ops/flash_attention.py:656"),
    "grouped_attention_bthd": ("proteingym_tpu_torch/ops/csrc/grouped_attention.cu",
                               "proteingym_tpu/ops/flash_attention.py:440"),
    # the pre-pass of K1/K4: the rotation the TPU kernels apply on load
    "rope_qk": ("proteingym_tpu_torch/ops/csrc/grouped_attention.cu",
                "proteingym_tpu/ops/flash_attention.py:156"),
    "cluster_counts": ("proteingym_tpu_torch/ops/csrc/cluster_counts.cu",
                       "proteingym_tpu/msa/weights.py:152"),
}
SOURCES = sorted({Path(src).stem for src, _ in KERNELS.values()})  # one nvcc each

# bf16 kernel vs a float32 plain version of the same bf16 inputs: the kernel
# rounds the scaled and rotated q/k to bf16 (2^-9 relative each) and its
# output to bf16 (2^-9 relative, |out| <= ~4 for unit-normal v), so errors
# reach ~1e-2; a masking or softmax bug is O(0.1-1).
BF16_ATOL, BF16_RTOL = 2e-2, 2e-2
# float32 kernel vs float32 plain version: only the summation order differs
F32_ATOL, F32_RTOL = 1e-4, 1e-4
# log-prob table rows, kernel vs plain attention through 33 bf16 layers: each
# attention output differs by ~1 bf16 ulp; the residual stream carries that
# to ~1e-2 in the log-probs. A wrong mask or position shifts them by O(1).
TABLE_ATOL = 1e-1
# PoET per-token log-probs, kernels vs plain attention through 12 bf16
# layers (24 attention calls) at T ~ 4,350: the same ~1 bf16 ulp per call,
# carried by the residual stream. A wrong mask, segment or rotation shifts
# them by O(1).
POET_LOGP_ATOL = 1e-1
GAP_AA = "-" + AA

# H100 SXM peaks (dense bf16 tensor cores, HBM3) for the bounds
PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 989e12, 3.35e12

# the shapes of phases 6-8
K5_TIMED = (16384, 300)  # (N, L) of the timed synthetic MSA
POET_ROW = (8, 16, 4352)  # (B, H, T) of PoET's attention calls at batch 8
POET_SLICE = dict(preset="poet_200m", length=250, n_seqs=16384, n_mut=128,
                  batch=8, n_samples=2, max_context_tokens=4096)
# the shapes of phases 9-11
K3_TIMED = (8, 20, 4096, 16, 250)  # (B, H, T, segments, segment length)
K4_TIMED = ((16, 20, 256), (32, 20, 1024))  # (B, H, T): the L=250 table, the window bucket
PACKED_MIX = (72, 118, 250, 448, 709, 1500)  # the JAX bench's production mix
PACKED_BATCH = 32  # rows per forward of the bucketed packed path
SEG_ROW_LEN, SEG_CHUNK = 4096, 8  # segment-packed rows and rows per forward
SEG_MIX = PACKED_MIX[:-1]  # L=1500's 1,024-token windows would add ~1.5M tokens
# the shapes of phase 12
WT_LONG = 3000  # five overlapping 1,024-token windows: [0, 1978, 511, 1467, 989]
PPPL_MUTANTS = 16  # pseudo-ppl: one masked table per mutant and one for the WT
# (assays, mutants per assay, model noise levels): ProteinGym's 217
# substitution assays, cut from ~2.5M mutants and 97 models
EVAL_SCALE = (217, 2000, tuple(0.2 * (j + 1) for j in range(10)))


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check_close(name, got, want, atol, rtol):
    got, want = got.float(), want.float()
    if not bool(got.isfinite().all()):
        fail(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    max_err = float(err.max())
    bad = err > atol + rtol * want.abs()
    status = "ok" if not bool(bad.any()) else "MISMATCH"
    print(f"  {name:<44s} max_abs_err={max_err:.3e} "
          f"(atol={atol:g}, rtol={rtol:g}) {status}")
    if status != "ok":
        fail(f"{name}: {int(bad.sum())} elements outside tolerance")
    return max_err


def time_ms(torch, fn, reps, inner=10):
    """Device milliseconds per call (CUDA events around ``inner`` queued
    calls, so the host's launch overhead hides behind the device work),
    one entry per sample."""
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / inner)
    return out


def check_launches(what, launches, want):
    """Fail unless a run launched exactly ``want`` ({counter: n}) and no
    other kernel."""
    full = {name: want.get(name, 0) for name in launches}
    if launches != full:
        fail(f"{what}: launch counts {launches}, expected {full}")


def bound(flops, nbytes):
    """The least time the card could take for work of ``flops`` bf16
    operations and ``nbytes`` of memory traffic, and which side sets it."""
    ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def sdpa(torch, q, k, v, mask):
    """One PyTorch call computing the attention function of the kernels on
    pre-rotated, pre-scaled (B, H, T, D) q/k/v with a boolean mask
    (True = attend): the yardstick, timed here and never used by the port."""
    return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                                    scale=1.0)


def sdpa_backend(torch, fn):
    """The backend SDPA's default dispatch took, read from the names of the
    kernels one call launches (torch.profiler)."""
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()]
    except Exception as e:  # the profiler is a reading aid here, not a check
        return f"not read ({type(e).__name__})"
    text = " ".join(names).lower()
    for key, label in (("cudnn", "cudnn"), ("flash", "flash"), ("fmha", "efficient"),
                       ("efficient", "efficient"), ("cutlass", "efficient")):
        if key in text:
            return label
    return "math" if names else "not read (no kernel events)"


def synth_assay(seq_len: int, seed: int):
    rs = np.random.RandomState(seed)
    seq = "".join(AA[i] for i in rs.randint(0, 20, seq_len))
    mutants = [f"{seq[p]}{p + 1}{m}" for p in range(seq_len) for m in AA
               if m != seq[p]]
    return seq, mutants


def write_assays(root: Path, assays, msa_columns=None):
    """A reference CSV plus one DMS CSV per (DMS_id, seq, mutants);
    ``msa_columns`` ({column: value}) adds the alignment columns."""
    msa_columns = msa_columns or {}
    dms_dir = root / "dms"
    dms_dir.mkdir()
    ref = root / "reference.csv"
    with open(ref, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["DMS_id", "DMS_filename", "UniProt_ID", "target_seq", "seq_len",
                    *msa_columns])
        for dms_id, seq, _ in assays:
            w.writerow([dms_id, f"{dms_id}.csv", "SYNTH", seq, len(seq),
                        *msa_columns.values()])
    rs = np.random.RandomState(0)
    for dms_id, _, mutants in assays:
        with open(dms_dir / f"{dms_id}.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["mutant", "DMS_score"])
            for m in mutants:
                w.writerow([m, f"{rs.randn():.6f}"])
    return ref, dms_dir


def run_cli(cli, ref, dms_dir, out_dir, checkpoint, batch_size):
    rc = cli.main([
        "score", "--model", "esm", "--checkpoint", checkpoint,
        "--dms-reference", str(ref), "--dms-dir", str(dms_dir),
        "--output-dir", str(out_dir), "--batch-size", str(batch_size),
        "--device", "cuda", "--quiet", "--fail-fast",
    ])
    if rc != 0:
        fail(f"CLI exited {rc} for {checkpoint}")


def read_scores(path: Path, column: str, n_expected: int) -> np.ndarray:
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    if len(rows) != n_expected:
        fail(f"{path.name}: {len(rows)} rows, expected {n_expected}")
    if any(not row.get(column) for row in rows):
        fail(f"{path.name}: column {column} missing or empty")
    scores = np.asarray([float(row[column]) for row in rows])
    if not np.isfinite(scores).all():
        fail(f"{path.name}: non-finite scores")
    return scores


def synth_family(focus: np.ndarray, n: int, seed: int) -> np.ndarray:
    """(n, L) int8 codes (0 = gap, 1..20 = amino acid) of a seeded
    synthetic family of ``focus``: cluster centres at 20-60% substitution,
    members at 0-15% from their centre, up to three gap runs of up to 30
    columns per row, so that neighbour counts vary. Row 0 is ``focus``."""
    rs = np.random.RandomState(seed)
    length = len(focus)
    n_centres = max(1, n // 16)
    centres = np.tile(focus, (n_centres, 1))
    sub = rs.rand(n_centres, length) < rs.uniform(0.2, 0.6, (n_centres, 1))
    centres[sub] = rs.randint(1, 21, sub.sum())
    rows = centres[rs.randint(0, n_centres, n)]
    sub = rs.rand(n, length) < rs.uniform(0.0, 0.15, (n, 1))
    rows[sub] = rs.randint(1, 21, sub.sum())
    cols = np.arange(length)[None, :]
    for _ in range(3):
        start = rs.randint(0, length, (n, 1))
        rows[(cols >= start) & (cols < start + rs.randint(0, 31, (n, 1)))] = 0
    rows[0] = focus
    return rows.astype(np.int8)


def write_a2m(path: Path, name: str, codes: np.ndarray) -> None:
    lut = np.frombuffer(GAP_AA.encode(), dtype=np.uint8)
    length = codes.shape[1]
    with open(path, "w") as f:
        for i, row in enumerate(codes):
            head = f">{name}/1-{length}" if i == 0 else f">{name}_hom{i}/1-{length}"
            f.write(f"{head}\n{bytes(lut[row.astype(np.int64)]).decode()}\n")


def median_pair(torch, fns, reps, inner, rounds=2):
    """Medians of ``time_ms`` samples for each named call, taken in turns
    (a, b, ..., b, a) ``rounds`` times so drift hits all alike."""
    for fn in fns.values():  # warm up
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]) * rounds:
        for which in order:
            times[which] += time_ms(torch, fns[which], reps, inner)
    return {k: statistics.median(v) for k, v in times.items()}


def n_chunk_forwards(seq_len, chunk, pad_to_multiple=64):
    """Forwards masked_marginal_table runs for L residues (L+2 tokens), on
    the short and the windowed path alike: rows bucketed to the pad
    multiple, then cut into chunks."""
    total = seq_len + 2
    rows = -(-total // pad_to_multiple) * pad_to_multiple
    return -(-rows // chunk)


def phase_cluster_counts(torch, dev, card):
    """6. K5 against its plain version, counts equal exactly; both timed at
    N=16,384, L=300."""
    from proteingym_tpu_torch.msa import weights as W

    print("[cluster_counts] K5 vs plain num_cluster_members on the card (exact)")
    rs = np.random.RandomState(0)
    for n, length, seed in ((1000, 123, 1), (4099, 300, 2), (77, 9, 3)):
        codes = synth_family(rs.randint(1, 21, length), n, seed)
        codes[3] = 0  # an all-gap row
        codes[7] = codes[8]  # duplicated rows
        codes[9, :5] = 21  # indeterminate codes: never match, count as non-gap
        m = torch.from_numpy(codes).to(dev)
        got = W.num_cluster_members_cuda(m, 0.8)
        same = torch.equal(got, W.num_cluster_members(m, 0.8)) and torch.equal(
            got.cpu(), W.num_cluster_members(torch.from_numpy(codes), 0.8))
        print(f"  N={n:<5d} L={length:<3d} counts {int(got.min())}..{int(got.max())}: "
              f"{'equal to the plain version (card bf16 and CPU float32)' if same else 'MISMATCH'}")
        if not same:
            fail(f"cluster counts differ from the plain version at N={n}, L={length}")

    n, length = K5_TIMED
    codes = synth_family(np.random.RandomState(5).randint(1, 21, length), n, 6)
    m = torch.from_numpy(codes).to(dev)
    got = W.num_cluster_members_cuda(m, 0.8)
    if not torch.equal(got, W.num_cluster_members(m, 0.8)):
        fail(f"cluster counts differ from the plain version at N={n}, L={length}")
    counts = got.cpu().numpy()
    neff = float(np.sum(1.0 / counts[counts > 0]))
    t = median_pair(torch, {
        "kernel": lambda: W.num_cluster_members_cuda(m, 0.8),
        "plain": lambda: W.num_cluster_members(m, 0.8),
    }, reps=3, inner=3)
    # the work of the TPU kernel's formulation: a one-hot (N, 20 L) Gram in
    # bf16 over the upper triangle, 2 operations per multiply-add
    b = bound(n * (n + 1) / 2 * 20 * length * 2, nbytes(m) + 4 * n)
    print(f"  N={n} L={length}: counts {int(counts.min())}..{int(counts.max())}, "
          f"Neff {neff:.1f}; kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, "
          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}); no single PyTorch call computes "
          f"it (medians of 12 samples of 3 queued calls, {card})")
    return {"ms": t["kernel"], "plain_ms": t["plain"], "library_ms": None, **b}


def phase_long_attention(torch, dev, card, fa, qkv, lengths_mask, check_close):
    """7. K2 against the plain version; K1 at PoET's self-tier shape; both
    timed at PoET's row shape."""
    print("[flash_attention] K2 vs plain reference_mha on the card")

    def compare(name, q, k, v, atol, rtol, **kw):
        got = fa.flash_mha(q, k, v, **kw)
        torch.cuda.synchronize()
        want = fa.reference_mha(q.float(), k.float(), v.float(), **kw)
        return check_close(name, got, want, atol, rtol)

    errs = []
    for dtype, atol, rtol, tag in ((torch.bfloat16, BF16_ATOL, BF16_RTOL, "bf16"),
                                   (torch.float32, F32_ATOL, F32_RTOL, "f32")):
        for t, lengths in ((2048, [2048, 1711]), (4352, [4352, 4100])):
            q, k, v = qkv(2, 4, t, 64, dtype)
            errs.append(compare(f"{tag} causal + mask T={t}", q, k, v, atol, rtol,
                                key_mask=lengths_mask(2, t, lengths), causal=True))
        q, k, v = qkv(1, 8, 1536, 64, dtype)
        slopes = 2.0 ** (-8.0 * torch.arange(1, 9, device=dev) / 8)
        alibi = slopes[:, None] * torch.arange(1536, device=dev)[None, :]
        errs.append(compare(f"{tag} ALiBi bias + causal T=1536", q, k, v, atol, rtol,
                            bias=alibi, causal=True))
        q, k, v = qkv(2, 4, 1100, 32, dtype)
        errs.append(compare(f"{tag} T=1100 (not a multiple of 64) D=32 mask", q, k, v,
                            atol, rtol, key_mask=lengths_mask(2, 1100, [1100, 901])))
        q, k, v = qkv(2, 4, 1037, 128, dtype)
        dead = torch.ones(2, 1037, dtype=torch.bool, device=dev)
        dead[1] = False  # every key of batch row 1 masked
        dead[0, :7] = False  # the first 7 queries of row 0 see no live key
        errs.append(compare(f"{tag} fully masked rows, causal T=1037 D=128", q, k, v,
                            atol, rtol, key_mask=dead, causal=True))
    max_abs_err = max(errs)

    print("[grouped_attention] K1 at PoET's self-tier shape: segmented + causal + RoPE")
    b, h, t = POET_ROW

    def segments(b):
        # 16 segments of ragged lengths per row, then 40 padding tokens
        seg = torch.zeros(b, t, dtype=torch.int32, device=dev)
        rs = np.random.RandomState(b)
        for i in range(b):
            cuts = np.sort(rs.choice(np.arange(100, t - 140), 15, replace=False))
            for s_id, (lo, hi) in enumerate(zip([0, *cuts], [*cuts, t - 40]), start=1):
                seg[i, lo:hi] = s_id
        return seg

    q, k, v = qkv(1, 8, t, 64)
    self_kw = dict(segment_ids=segments(1), causal=True, rope_base=10000.0)
    got = fa.grouped_mha(q, k, v, **self_kw)
    torch.cuda.synchronize()
    want = fa.plain_mha(q.float(), k.float(), v.float(), **self_kw)
    live = self_kw["segment_ids"] > 0  # padding rows are never consumed
    k1_self_err = check_close(f"bf16 B1 H8 T{t}, 16 segments (live rows)",
                              got.transpose(1, 2)[live], want.transpose(1, 2)[live],
                              BF16_ATOL, BF16_RTOL)

    d = 64
    q, k, v = qkv(b, h, t, d)
    lengths = [t - 7 * i for i in range(b)]
    mask = lengths_mask(b, t, lengths)
    causal_mask = mask[:, None, None, :] & torch.ones(t, t, dtype=torch.bool, device=dev).tril()
    k2t = median_pair(torch, {
        "kernel": lambda: fa.flash_mha(q, k, v, key_mask=mask, causal=True, sm_scale=1.0),
        "plain": lambda: fa.reference_mha(q, k, v, key_mask=mask, causal=True, sm_scale=1.0),
        "sdpa": sdpa(torch, q, k, v, causal_mask),
    }, reps=2, inner=3)
    # pairs a row attends: the live keys at or before it
    pairs = sum(n * (n + 1) // 2 + (t - n) * n for n in lengths) * h
    k2b = bound(4 * d * pairs, nbytes(q, k, v, q, mask))
    print(f"  K2 at B{b} H{h} T{t} D64, causal + mask: kernel {k2t['kernel']:.4f} ms, "
          f"plain {k2t['plain']:.4f} ms, SDPA {k2t['sdpa']:.4f} ms "
          f"({sdpa_backend(torch, sdpa(torch, q, k, v, causal_mask))}), bound "
          f"{k2b['bound_ms']:.4f} ms ({k2b['bound_by']}) (medians of 8 samples of 3 queued "
          f"calls, {card})")
    del causal_mask
    seg = segments(b)
    # one KeyTiles for every call, as PoET's forward shares one by its layers
    tiles = fa.KeyTiles(seg, causal=True)
    self_kw = dict(segment_ids=seg, causal=True, rope_base=10000.0, key_tiles=tiles)
    # the loop alone on q/k the pre-pass rotated and scaled, as SDPA gets them
    qr, kr = fa.rope_qk(q, k, 1.0 / d ** 0.5, 10000.0)
    loop_kw = dict(segment_ids=seg, causal=True, sm_scale=1.0, key_tiles=tiles)
    self_mask = ((seg[:, :, None] == seg[:, None, :])[:, None]
                 & torch.ones(t, t, dtype=torch.bool, device=dev).tril())
    k1t = median_pair(torch, {
        "kernel": lambda: fa.grouped_mha(qr, kr, v, **loop_kw),
        "plain": lambda: fa.plain_mha(qr, kr, v, **loop_kw),
        "sdpa": sdpa(torch, qr, kr, v, self_mask),
        "call": lambda: fa.grouped_mha(q, k, v, **self_kw),
    }, reps=2, inner=3)
    # the timed call, held against the plain version on live rows, one batch
    # row at a time: each row has its own cuts and so its own extents
    got = fa.grouped_mha(q, k, v, **self_kw).float()
    torch.cuda.synchronize()
    want = torch.cat([fa.plain_mha(*(x[i:i + 1].float() for x in (q, k, v)),
                                   segment_ids=seg[i:i + 1], causal=True, rope_base=10000.0)
                      for i in range(b)])
    live = seg > 0
    k1_self_err = max(k1_self_err, check_close(
        f"bf16 B{b} H{h} T{t}, own 16 segments per row (live rows)",
        got.transpose(1, 2)[live], want.transpose(1, 2)[live], BF16_ATOL, BF16_RTOL))
    del got, want
    lo, hi = tiles.extents(b, t, dev)
    runs = torch.unique_consecutive(seg[seg > 0].view(-1), return_counts=True)[1].double()
    k1b = bound(4 * d * h * float((runs * (runs + 1) / 2).sum()), nbytes(q, k, v, q, seg))
    print(f"  K1 at B{b} H{h} T{t} D64, 16 segments + causal: Hopper loop {k1t['kernel']:.4f} ms "
          f"({(hi - lo).float().mean().item():.2f} of {-(-t // fa.KERNEL_TILE)} key tiles per "
          f"128-query tile), plain {k1t['plain']:.4f} ms, SDPA {k1t['sdpa']:.4f} ms "
          f"({sdpa_backend(torch, sdpa(torch, qr, kr, v, self_mask))}), bound "
          f"{k1b['bound_ms']:.4f} ms ({k1b['bound_by']}); the call with RoPE (pre-pass + loop) "
          f"{k1t['call']:.4f} ms ({card})")
    del q, k, v, qr, kr, self_mask
    torch.cuda.empty_cache()
    return {"max_abs_err": max_abs_err, "ms": k2t["kernel"], "plain_ms": k2t["plain"],
            "library_ms": k2t["sdpa"], **k2b, "k1_self_err": k1_self_err,
            "k1": {"ms": k1t["kernel"], "plain_ms": k1t["plain"], "library_ms": k1t["sdpa"],
                   "call_ms": k1t["call"], **k1b}}


def phase_poet(torch, dev, card, fa, check_close):
    """8. The PoET slice through the port's CLI: weights on K5, then
    scoring with K1 (self tier) and K2 (multi tier) in every layer."""
    from proteingym_tpu_torch.models import poet
    from proteingym_tpu_torch.msa import weights as W
    from proteingym_tpu_torch.msa.parser import load_msa
    from proteingym_tpu_torch.pipeline import cli

    preset = POET_SLICE["preset"]
    config = poet.POET_PRESETS[preset]
    length, n_seqs, n_mut, batch, n_samples, max_tokens = (POET_SLICE[k] for k in (
        "length", "n_seqs", "n_mut", "batch", "n_samples", "max_context_tokens"))
    print(f"[poet] weights, then score --model poet --checkpoint {preset}: L={length}, "
          f"{n_mut} single mutants, MSA N={n_seqs}")
    rs = np.random.RandomState(7)
    focus = rs.randint(1, 21, length)
    seq = "".join(GAP_AA[c] for c in focus)
    mutants, mutated = [], []
    for p in sorted(rs.choice(length, n_mut, replace=False)):
        aa = rs.choice([a for a in AA if a != seq[p]])
        mutants.append(f"{seq[p]}{p + 1}{aa}")
        mutated.append(seq[:p] + aa + seq[p + 1:])

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        msa_dir, weights_dir, out_dir = root / "msa", root / "weights", root / "out"
        msa_dir.mkdir()
        write_a2m(msa_dir / "SYNTH.a2m", "SYNTH", synth_family(focus, n_seqs, 8))
        ref, dms_dir = write_assays(root, [("SYNTH_POET", seq, mutants)], {
            "MSA_filename": "SYNTH.a2m", "MSA_start": 1, "MSA_end": length,
            "MSA_theta": 0.2, "weight_file_name": "SYNTH.npy",
        })
        wfile = weights_dir / "SYNTH.npy"

        for counts in (fa.LAUNCHES, W.LAUNCHES):
            for name in counts:
                counts[name] = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = cli.main(["weights", "--msa", str(msa_dir / "SYNTH.a2m"), "--theta", "0.2",
                       "--output", str(wfile), "--device", "cuda"])
        weights_s = time.perf_counter() - t0
        if rc != 0 or not wfile.exists():
            fail(f"weights CLI exited {rc}, file written: {wfile.exists()}")
        k5_launches, stamp = W.LAUNCHES["cluster_counts"], wfile.stat().st_mtime_ns
        t0 = time.perf_counter()
        rc = cli.main([
            "score", "--model", "poet", "--checkpoint", preset,
            "--msa-dir", str(msa_dir), "--weights-dir", str(weights_dir),
            "--dms-reference", str(ref), "--dms-dir", str(dms_dir),
            "--output-dir", str(out_dir), "--batch-size", str(batch),
            "--device", "cuda", "--quiet", "--fail-fast",
            "--extra", f"max_context_tokens={max_tokens}", f"n_context_samples={n_samples}",
        ])
        wall = time.perf_counter() - t0
        launches = {**fa.LAUNCHES, **W.LAUNCHES}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if rc != 0:
            fail(f"poet score CLI exited {rc}")
        if W.LAUNCHES["cluster_counts"] != k5_launches or wfile.stat().st_mtime_ns != stamp:
            fail("the score run recomputed the weights instead of reusing the file")
        scores = read_scores(out_dir / "SYNTH_POET.csv", "PoET_score", n_mut)
        msa = load_msa(msa_dir / "SYNTH.a2m")
        weights = np.load(wfile)

    n_fwd = n_samples * -(-n_mut // batch)
    expected = config.num_layers * n_fwd
    print(f"  weights CLI {weights_s:.2f} s (parse + K5); score CLI wall {wall:.2f} s incl. "
          f"weight init and MSA load; peak device memory {peak_gib:.2f} GiB")
    print(f"  launches {launches} (expected {config.num_layers} layers x {n_fwd} forwards "
          f"= {expected} each for K1, its rope_qk pre-pass and K2, >= 1 cluster_counts)")
    if (launches["flash_attention"] != expected or launches["grouped_attention"] != expected
            or launches["rope_qk"] != expected or launches["cluster_counts"] < 1):
        fail(f"launch counts {launches} do not match the slice")

    model = poet.init_random(config, seed=0, device=dev)
    msa_seqs = msa.sequences()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rescored = poet.score_assay_poet(model, mutated, msa_seqs, weights,
                                     max_context_tokens=max_tokens, n_context_samples=n_samples,
                                     batch_size=batch)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    if not np.allclose(rescored, scores, atol=1e-4):
        fail("PoET scores recomputed outside the CLI differ from the CLI's")
    ctx = poet.sample_context(msa_seqs, weights, max_tokens, 0)
    tok, seg, pos, val, _ = (torch.from_numpy(a).to(dev)
                             for a in poet.build_rows(ctx, mutated[:2]))
    print(f"  scoring {score_s:.3f} s -> {n_mut / score_s:.2f} mutants/s; rows of "
          f"T={tok.shape[1]} tokens ({len(ctx)} context sequences + the query), "
          f"N={len(weights)} Neff={weights.sum():.1f} ({card})")
    got = poet.token_logprobs(model, tok, seg, pos, val)
    with mock.patch.object(poet, "mha", fa.plain_mha):
        want = poet.token_logprobs(model, tok, seg, pos, val)
    live = val[:, 1:].bool()
    check_close(f"2 queries' per-token log-probs, T={tok.shape[1]}, kernels vs plain",
                got[live], want[live], POET_LOGP_ATOL, 0.0)
    del model
    torch.cuda.empty_cache()
    return {"launches": launches, "mutants_per_s": n_mut / score_s}


def segment_runs(torch, dev, b, t, bounds):
    """(b, t) int32 segment ids: segment i + 1 on [bounds[i], bounds[i+1])."""
    seg = torch.zeros(b, t, dtype=torch.int32, device=dev)
    for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        seg[:, lo:hi] = i + 1
    return seg


def phase_k3_k4(torch, dev, card, fa, qkv, lengths_mask, check_close):
    """9. K3 and K4 against their plain versions (live query rows) in bf16
    and float32; K3 timed at the packed-row shape, K4 at the headline."""
    print("[seg_block_attention] K3 vs plain seg_block_mha on the card (live rows)")
    k3_errs = []
    for dtype, atol, rtol, tag in ((torch.bfloat16, BF16_ATOL, BF16_RTOL, "bf16"),
                                   (torch.float32, F32_ATOL, F32_RTOL, "f32")):
        cases = [  # name, (B, H, T, D), segment bounds, keyword arguments
            ("segments across tiles + padded tail", (2, 4, 512, 64), [0, 200, 310, 470], {}),
            ("one segment spanning the row, RoPE", (2, 4, 512, 64), [0, 512],
             {"rope_base": 10000.0}),
            ("T=1100 (ragged tile) D=32, RoPE", (2, 4, 1100, 32), [0, 90, 91, 500, 1037],
             {"rope_base": 10000.0}),
            ("T=4096, 16 x 250 + tail, RoPE", (1, 4, 4096, 64), list(range(0, 4001, 250)),
             {"rope_base": 10000.0}),
        ]
        for name, (b, h, t, d), bounds, kw in cases:
            q, k, v = qkv(b, h, t, d, dtype)
            seg = segment_runs(torch, dev, b, t, bounds)
            got = fa.seg_block_mha(q, k, v, seg, **kw)
            torch.cuda.synchronize()
            want = fa.plain_seg_block_mha(q.float(), k.float(), v.float(), seg, **kw)
            live = seg > 0
            k3_errs.append(check_close(f"{tag} {name}", got.transpose(1, 2)[live],
                                       want.transpose(1, 2)[live], atol, rtol))
        # a key mask folded into the segments by mha (T > 1024, not causal)
        q, k, v = qkv(2, 4, 1152, 64, dtype)
        seg = segment_runs(torch, dev, 2, 1152, [0, 300, 700, 1100])
        mask = seg > 0
        mask[1, 650:700] = False
        before = fa.LAUNCHES["seg_block_attention"]
        got = fa.mha(q, k, v, key_mask=mask, segment_ids=seg, rope_base=10000.0)
        torch.cuda.synchronize()
        if fa.LAUNCHES["seg_block_attention"] != before + 1:
            fail("mha did not route the segmented T=1152 call to K3")
        want = fa.plain_mha(q.float(), k.float(), v.float(), key_mask=mask, segment_ids=seg,
                            rope_base=10000.0)
        k3_errs.append(check_close(f"{tag} mha T=1152, key mask folded into segments",
                                   got.transpose(1, 2)[mask], want.transpose(1, 2)[mask],
                                   atol, rtol))

    print("[grouped_attention_bthd] K4 vs plain grouped_mha_bthd on the card")

    def bthd(b, h, t, d, dtype=torch.bfloat16):
        return tuple(x.transpose(1, 2) for x in qkv(b, h, t, d, dtype))

    k4_errs = []
    dead = torch.ones(2, 100, dtype=torch.bool, device=dev)
    dead[1] = False  # every key of batch row 1 masked
    seg = segment_runs(torch, dev, 2, 300, [0, 90, 200, 290])
    for dtype, atol, rtol, tag in ((torch.bfloat16, BF16_ATOL, BF16_RTOL, "bf16"),
                                   (torch.float32, F32_ATOL, F32_RTOL, "f32")):
        cases = [
            ("headline B16 H20 T256 D64 mask+rope", (16, 20, 256, 64),
             {"key_mask": lengths_mask(16, 256, [252 - 3 * i for i in range(16)]),
              "rope_base": 10000.0}),
            ("segments + mask + rope", (2, 4, 300, 64),
             {"segment_ids": seg, "key_mask": seg > 0, "rope_base": 10000.0}),
            ("causal", (2, 8, 200, 64), {"causal": True}),
            ("fully masked row, ragged T=100", (2, 4, 100, 32), {"key_mask": dead}),
        ]
        if dtype == torch.bfloat16:  # the window bucket (the float32 presets stay short)
            cases.append(("window bucket B32 H20 T1024 D64 mask+rope", (32, 20, 1024, 64),
                          {"key_mask": lengths_mask(32, 1024, [1024 - 9 * i for i in range(32)]),
                           "rope_base": 10000.0}))
        for name, shape, kw in cases:
            q, k, v = bthd(*shape, dtype)
            got = fa.grouped_mha_bthd(q, k, v, **kw)
            torch.cuda.synchronize()
            want = fa.plain_mha_bthd(q.float(), k.float(), v.float(), **kw)
            if "segment_ids" in kw:
                live = kw["segment_ids"] > 0
                got, want = got[live], want[live]
            k4_errs.append(check_close(f"{tag} {name}", got, want, atol, rtol))

    b, h, t, n_seg, seg_len = K3_TIMED
    d = 64
    q, k, v = qkv(b, h, t, d)
    seg = segment_runs(torch, dev, b, t, list(range(0, n_seg * seg_len + 1, seg_len)))
    lo, hi = fa._segment_block_extents(
        torch.nn.functional.pad(seg, (0, -t % fa.KERNEL_TILE)), -(-t // fa.KERNEL_TILE),
        fa.KERNEL_TILE)
    tiles = (hi - lo).float().mean().item()
    qr, kr = fa.plain_rope_qk(q, k, 1.0, 10000.0)  # SDPA's operands: pre-rotated
    seg_mask = (seg[:, :, None] == seg[:, None, :])[:, None]
    k3t = median_pair(torch, {
        "kernel": lambda: fa.seg_block_mha(q, k, v, seg, sm_scale=1.0, rope_base=10000.0),
        "plain": lambda: fa.plain_seg_block_mha(q, k, v, seg, sm_scale=1.0, rope_base=10000.0),
        "k1": lambda: fa.grouped_mha(q, k, v, key_mask=seg > 0, segment_ids=seg, sm_scale=1.0,
                                     rope_base=10000.0),
        "sdpa": sdpa(torch, qr, kr, v, seg_mask),
    }, reps=2, inner=3)
    # live rows attend their own segment; K3 also reads the RoPE tables
    k3b = bound(4 * d * h * b * n_seg * seg_len ** 2, nbytes(q, k, v, q, seg) + 2 * 4 * t * d)
    print(f"  K3 at B{b} H{h} T{t} D64, {n_seg} segments of {seg_len} + padded tail, RoPE: "
          f"{tiles:.2f} of {-(-t // fa.KERNEL_TILE)} key tiles per query tile; kernel "
          f"{k3t['kernel']:.4f} ms, plain {k3t['plain']:.4f} ms, K1 segmented (pre-pass + "
          f"Hopper loop) {k3t['k1']:.4f} ms, SDPA on pre-rotated q/k {k3t['sdpa']:.4f} ms "
          f"({sdpa_backend(torch, sdpa(torch, qr, kr, v, seg_mask))}), bound "
          f"{k3b['bound_ms']:.4f} ms ({k3b['bound_by']}) (medians of 8 samples of 3 queued "
          f"calls, {card})")
    del q, k, v, qr, kr, seg_mask
    torch.cuda.empty_cache()

    k4 = {}
    for b, h, t in K4_TIMED:
        q, k, v = bthd(b, h, t, d)
        mask = lengths_mask(b, t, [t - 4 - 3 * i for i in range(b)])
        call = dict(key_mask=mask, sm_scale=1.0, rope_base=10000.0)  # ESM's call
        tr = lambda x: x.transpose(1, 2)
        qr, kr = (tr(x) for x in fa.rope_qk(tr(q), tr(k), 1.0, 10000.0))
        sdpa_mask = mask[:, None, None, :]
        k4t = median_pair(torch, {
            "plain": lambda: fa.plain_mha_bthd(qr, kr, v, key_mask=mask, sm_scale=1.0),
            "kernel": lambda: fa.grouped_mha_bthd(qr, kr, v, key_mask=mask, sm_scale=1.0),
            "sdpa": sdpa(torch, tr(qr), tr(kr), tr(v), sdpa_mask),
            "call": lambda: fa.grouped_mha_bthd(q, k, v, **call),
        }, reps=5, inner=10, rounds=3)
        live = mask.sum().item()  # every query row attends the live keys of its row
        k4b = bound(4 * d * h * t * live, nbytes(q, k, v, q, mask))
        print(f"  K4 at B{b} H{h} T{t} D64 mask: Hopper loop {k4t['kernel']:.4f} ms, plain "
              f"{k4t['plain']:.4f} ms, SDPA {k4t['sdpa']:.4f} ms "
              f"({sdpa_backend(torch, sdpa(torch, tr(qr), tr(kr), tr(v), sdpa_mask))}), bound "
              f"{k4b['bound_ms']:.4f} ms ({k4b['bound_by']}); the call with RoPE (pre-pass + "
              f"loop) {k4t['call']:.4f} ms (medians of 30 samples of 10 queued calls, {card})")
        k4[(b, h, t)] = {"shape": f"B{b} H{h} T{t} D{d}", "ms": k4t["kernel"],
                         "plain_ms": k4t["plain"], "library_ms": k4t["sdpa"],
                         "call_ms": k4t["call"], **k4b}
        if t == 1024:  # the pre-pass at the window bucket
            rt = median_pair(torch, {
                "plain": lambda: fa.plain_rope_qk(tr(q), tr(k), 1.0, 10000.0),
                "kernel": lambda: fa.rope_qk(tr(q), tr(k), 1.0, 10000.0),
            }, reps=5, inner=10)
            got, want = fa.rope_qk(tr(q), tr(k), 1.0, 10000.0), fa.plain_rope_qk(
                tr(q), tr(k), 1.0, 10000.0)
            rope_err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
            # q and k read, q' and k' written, the float32 cos/sin tables read
            rb = bound(0, 2 * nbytes(q, k) + 2 * 4 * t * d)
            print(f"  rope_qk at B{b} H{h} T{t} D64: kernel {rt['kernel']:.4f} ms, plain "
                  f"{rt['plain']:.4f} ms, bound {rb['bound_ms']:.4f} ms ({rb['bound_by']}); "
                  f"max abs err {rope_err:.3e} ({card})")
            if rope_err != 0.0:  # the plain version's rounding steps, bit for bit
                fail(f"rope_qk differs from its plain version by {rope_err:.3e}")
            rope = {"max_abs_err": rope_err, "ms": rt["kernel"], "plain_ms": rt["plain"],
                    "library_ms": None, **rb}
        del q, k, v, qr, kr
        torch.cuda.empty_cache()
    main, other = k4[K4_TIMED[1]], k4[K4_TIMED[0]]
    return {
        "seg_block_attention": dict(max_abs_err=max(k3_errs), ms=k3t["kernel"],
                                    plain_ms=k3t["plain"], library_ms=k3t["sdpa"], **k3b),
        "grouped_attention_bthd": dict(max_abs_err=max(k4_errs), **main, other_shapes=[other]),
        "rope_qk": rope,
    }


def packed_forwards(lengths, chunk, window=1024, pad_to_multiple=32):
    """Forwards the bucketed packed path runs: L+2 rows per assay, grouped
    by row bucket (a multiple of the pad, at most the window), each group
    cut into chunks."""
    rows = {}
    for length in lengths:
        total = length + 2
        bucket = min(-(-total // pad_to_multiple) * pad_to_multiple, window)
        rows[bucket] = rows.get(bucket, 0) + total
    return sum(-(-n // chunk) for n in rows.values())


def phase_packed(torch, card, fa, cli, esm2, scores_250):
    """10. ``score --packed`` through the CLI on the production mix, twice;
    the second run is timed and counted."""
    print(f"[packed] score --model esm --checkpoint esm2_t33_650M --packed, L={PACKED_MIX}")
    assays = [(f"SYNTH_P{length}", *synth_assay(length, 0 if length == 250 else length))
              for length in PACKED_MIX]
    n_mut = sum(len(m) for _, _, m in assays)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ref, dms_dir = write_assays(root, assays)
        args = ["score", "--model", "esm", "--checkpoint", "esm2_t33_650M", "--packed",
                "--dms-reference", str(ref), "--dms-dir", str(dms_dir),
                "--output-dir", str(root / "out"), "--batch-size", str(PACKED_BATCH),
                "--device", "cuda", "--quiet", "--fail-fast", "--overwrite"]
        walls = []
        for _ in range(2):  # warm, then the run that is timed and counted
            for name in fa.LAUNCHES:
                fa.LAUNCHES[name] = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if cli.main(args) != 0:
                fail("packed CLI exited non-zero")
            walls.append(time.perf_counter() - t0)
        launches = dict(fa.LAUNCHES)
        events = [json.loads(line) for line in (root / "out" / "events.jsonl").open()]
        scores = {length: read_scores(root / "out" / f"{dms_id}.csv", "esm2_t33_650M_score",
                                      len(mutants))
                  for (dms_id, _, mutants), length in zip(assays, PACKED_MIX)}
    thr = [e for e in events if e["event"] == "throughput"][-1]
    n_fwd = packed_forwards(PACKED_MIX, PACKED_BATCH)
    expected = esm2.PRESETS["esm2_t33_650M"].num_layers * n_fwd
    print(f"  {n_mut} finite scores; timed run: score_packed {thr['seconds']:.3f} s incl. "
          f"weight init -> {thr['mutants_per_sec']:.2f} mutants/s; CLI wall {walls[1]:.2f} s "
          f"(warm-up run {walls[0]:.2f} s); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    print(f"  launches {launches} (expected 33 layers x {n_fwd} forwards = {expected} of K4 "
          f"and of its rope_qk pre-pass)")
    check_launches("packed", launches, {"grouped_attention_bthd": expected, "rope_qk": expected})
    err = float(np.abs(scores[250] - scores_250).max())
    print(f"  L=250 scores vs the per-assay path (phase 4): max_abs_err={err:.3e} "
          f"(atol={TABLE_ATOL:g}) {'ok' if err <= TABLE_ATOL else 'MISMATCH'}")
    if err > TABLE_ATOL:
        fail("packed L=250 scores differ from the per-assay scores")
    return {"launches": launches, "scores": scores, "mutants_per_s": thr["mutants_per_sec"]}


def packed_rows(torch, dev, esm2, token_list, n_rows, row_len):
    """``n_rows`` rows of ``row_len`` tokens packing the given token vectors
    in turn as segments (one position masked in each), then padding."""
    rs = np.random.RandomState(3)
    tok = torch.full((n_rows, row_len), esm2.ALPHABET.padding_idx, dtype=torch.long)
    seg = torch.zeros(n_rows, row_len, dtype=torch.int32)
    i = 0
    for r in range(n_rows):
        begin, s_id = 0, 1
        while s_id <= esm2.MAX_ROW_SEGMENTS and begin + len(token_list[i]) <= row_len:
            t = torch.from_numpy(token_list[i].astype(np.int64))
            t[rs.randint(1, len(t) - 1)] = esm2.ALPHABET.mask_idx
            tok[r, begin:begin + len(t)] = t
            seg[r, begin:begin + len(t)] = s_id
            begin, s_id, i = begin + len(t), s_id + 1, (i + 1) % len(token_list)
    return tok.to(dev), seg.to(dev)


def phase_segment_packed(torch, dev, card, fa, esm2, check_close, packed_scores):
    """11. The segment-packed path at row_len 4096 (K3 in every layer),
    twice; the second run is timed and counted."""
    from proteingym_tpu_torch.models import packed_scoring

    print(f"[segment_packed] score_assays_packed(seg_apply_fn=..., row_len={SEG_ROW_LEN}) "
          f"with esm2_t33_650M, L={SEG_MIX}")
    config = esm2.PRESETS["esm2_t33_650M"]
    model = esm2.init_random(config, seed=0, device=dev)  # the CLI's weights
    assays = [synth_assay(length, 0 if length == 250 else length) for length in SEG_MIX]
    n_mut = sum(len(m) for _, m in assays)
    token_list = [esm2.ALPHABET.tokenize(seq) for seq, _ in assays]
    seg_fn = esm2.make_segmented_apply_fn(model)
    runs = []
    for _ in range(2):  # warm, then the run that is timed and counted
        for name in fa.LAUNCHES:
            fa.LAUNCHES[name] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = packed_scoring.score_assays_packed(
            None, assays, seg_apply_fn=seg_fn, row_len=SEG_ROW_LEN, seg_chunk=SEG_CHUNK)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    launches = dict(fa.LAUNCHES)
    counts = {}
    for toks in token_list:
        counts[len(toks)] = counts.get(len(toks), 0) + len(toks)
    n_rows = len(packed_scoring._plan_rows(counts, SEG_ROW_LEN, esm2.MAX_ROW_SEGMENTS))
    n_fwd = -(-n_rows // SEG_CHUNK)
    expected = config.num_layers * n_fwd
    print(f"  {n_mut} scores in {runs[1]:.3f} s -> {n_mut / runs[1]:.2f} mutants/s "
          f"(warm-up run {runs[0]:.2f} s); {n_rows} rows of {SEG_ROW_LEN} tokens, "
          f"{sum(counts.values())} masked rows packed ({card})")
    print(f"  launches {launches} (expected 33 layers x {n_fwd} forwards = {expected} of K3)")
    check_launches("segment-packed", launches, {"seg_block_attention": expected})
    errs = [float(np.abs(got - packed_scores[length]).max())
            for got, length in zip(scores, SEG_MIX)]
    if not all(np.isfinite(s).all() for s in scores):
        fail("segment-packed scores are not finite")
    print(f"  scores vs the bucketed packed scores (phase 10): max_abs_err={max(errs):.3e} "
          f"(atol={TABLE_ATOL:g}) {'ok' if max(errs) <= TABLE_ATOL else 'MISMATCH'}")
    if max(errs) > TABLE_ATOL:
        fail("segment-packed scores differ from the bucketed packed scores")

    tok, seg = packed_rows(torch, dev, esm2, token_list, 2, SEG_ROW_LEN)
    with torch.no_grad():
        got = torch.log_softmax(seg_fn(tok, seg), dim=-1)
        with mock.patch.object(esm2, "mha_natural", fa.plain_mha_bthd):
            want = torch.log_softmax(seg_fn(tok, seg), dim=-1)
    live = seg > 0
    check_close(f"2 packed rows' log-probs, T={SEG_ROW_LEN}, "
                f"{int(seg.max(dim=1).values.sum())} segments, K3 vs plain",
                got[live], want[live], TABLE_ATOL, 0.0)
    del model
    torch.cuda.empty_cache()
    return {"launches": launches, "mutants_per_s": n_mut / runs[1]}



def score_cli(cli, ref, dms_dir, dms_id, out_dir, chunk, strategy):
    """``score --model esm --checkpoint esm2_t33_650M`` of one assay with a
    scoring strategy."""
    rc = cli.main([
        "score", "--model", "esm", "--checkpoint", "esm2_t33_650M",
        "--dms-reference", str(ref), "--dms-dir", str(dms_dir), "--dms-id", dms_id,
        "--output-dir", str(out_dir), "--batch-size", str(chunk), "--device", "cuda",
        "--quiet", "--fail-fast", "--extra", f"scoring_strategy={strategy}",
    ])
    if rc != 0:
        fail(f"score CLI exited {rc} for {dms_id}, scoring_strategy={strategy}")


def write_csv_rows(path: Path, header, rows) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def write_reference(path: Path, rows) -> None:
    """A DMS reference CSV with the columns merge and evaluate read."""
    write_csv_rows(path, ["DMS_id", "DMS_filename", "UniProt_ID", "target_seq", "seq_len",
                          "taxon", "coarse_selection_type", "MSA_Neff_L_category",
                          "DMS_total_number_mutants"], rows)


def read_table(path: Path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def phase_wt_pppl(torch, dev, card, fa, cli, esm2, esm_scoring, masked):
    """12a-b. wt-marginals at L=250 and L=3000, then pseudo-ppl at L=250,
    through the CLI with ESM2-650M; K4 launches counted, tables held
    against the plain attention."""
    from proteingym_tpu_torch.data.mutants import apply_mutant

    seq, mutants, masked_scores, chunk = masked
    config = esm2.PRESETS["esm2_t33_650M"]
    long_seq, long_all = synth_assay(WT_LONG, 2)
    long_mutants = long_all[::19]
    pppl_mutants = mixed_mutants(seq, PPPL_MUTANTS)
    assays = [("SYNTH_L250", seq, mutants), (f"SYNTH_L{WT_LONG}", long_seq, long_mutants)]
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ref, dms_dir = write_assays(root, assays)
        print(f"[wt_marginals] score --extra scoring_strategy=wt-marginals, "
              f"esm2_t33_650M, L=250 and L={WT_LONG}")
        wt_launches, cli_scores = {}, {}
        for dms_id, _, muts in assays:
            for name in fa.LAUNCHES:
                fa.LAUNCHES[name] = 0
            score_cli(cli, ref, dms_dir, dms_id, root / "wt", chunk, "wt-marginals")
            counts = dict(fa.LAUNCHES)
            cli_scores[dms_id] = read_scores(root / "wt" / f"{dms_id}.csv",
                                             "esm2_t33_650M_score", len(muts))
            print(f"  {dms_id}: {len(muts)} finite scores; launches {counts} (expected "
                  f"{config.num_layers} of K4 and of rope_qk: one forward)")
            check_launches(f"wt-marginals {dms_id}", counts,
                           {"grouped_attention_bthd": config.num_layers,
                            "rope_qk": config.num_layers})
            for name, c in counts.items():
                wt_launches[name] = wt_launches.get(name, 0) + c
        wt_rows_250 = read_table(root / "wt" / "SYNTH_L250.csv")

        model = esm2.init_random(config, seed=0, device=dev)  # the CLI's weights
        for dms_id, s, muts in assays:
            name = f"L={len(s)}"
            tokens = esm2.ALPHABET.tokenize(s)
            plan = esm_scoring.overlapping_window_plan(len(tokens), config.max_positions)
            table = esm_scoring.wt_marginal_table_overlapping(model, tokens,
                                                              window=config.max_positions)
            rescored = esm_scoring.score_mutants_from_table(table, muts, s)
            if not np.allclose(rescored, cli_scores[dms_id], atol=1e-5):
                fail(f"wt-marginal scores at {name} recomputed outside the CLI differ")
            runs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                esm_scoring.wt_marginal_table_overlapping(model, tokens,
                                                          window=config.max_positions)
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t0)
            with mock.patch.object(esm2, "mha_natural", fa.plain_mha_bthd):
                plain = esm_scoring.wt_marginal_table_overlapping(model, tokens,
                                                                  window=config.max_positions)
            windows = (f"{len(plan)} windows {plan} in one forward"
                       if len(tokens) > config.max_positions else "one forward")
            print(f"  {name} ({len(tokens)} tokens, {windows}): table "
                  f"{statistics.median(runs) * 1e3:.2f} ms median of 3 ({card})")
            check_close(f"wt table {name}, kernel vs plain attention", table, plain,
                        TABLE_ATOL, 0.0)

        print(f"[pseudo_ppl] score --extra scoring_strategy=pseudo-ppl, esm2_t33_650M, "
              f"L=250, {len(pppl_mutants)} mutants (singles and doubles)")
        (root / "p").mkdir()
        ref_p, dms_p = write_assays(root / "p", [("SYNTH_L250", seq, pppl_mutants)])
        for name in fa.LAUNCHES:
            fa.LAUNCHES[name] = 0
        t0 = time.perf_counter()
        score_cli(cli, ref_p, dms_p, "SYNTH_L250", root / "pppl", chunk, "pseudo-ppl")
        pppl_wall = time.perf_counter() - t0
        pppl_launches = dict(fa.LAUNCHES)
        pppl_scores = read_scores(root / "pppl" / "SYNTH_L250.csv", "esm2_t33_650M_score",
                                  len(pppl_mutants))
        n_tables = len(pppl_mutants) + 1
        expected = config.num_layers * n_tables * n_chunk_forwards(250, chunk)
        print(f"  launches {pppl_launches} (expected {config.num_layers} layers x {n_tables} "
              f"tables x {n_chunk_forwards(250, chunk)} forwards = {expected} of K4 and of "
              f"rope_qk); CLI wall {pppl_wall:.2f} s incl. weight init")
        check_launches("pseudo-ppl", pppl_launches,
                       {"grouped_attention_bthd": expected, "rope_qk": expected})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        esm_scoring.score_assay(model, seq, pppl_mutants, strategy="pseudo-ppl", chunk=chunk,
                                window=config.max_positions)
        torch.cuda.synchronize()
        pppl_s = time.perf_counter() - t0
        print(f"  pseudo-ppl scoring {pppl_s:.3f} s -> {len(pppl_mutants) / pppl_s:.2f} "
              f"mutants/s ({n_tables} masked tables; {card})")
        mut_seq = apply_mutant(seq, pppl_mutants[-1])
        tables = {}
        for name, s in (("WT", seq), (pppl_mutants[-1], mut_seq)):
            tokens = esm2.ALPHABET.tokenize(s)
            kw = dict(chunk=chunk, window=config.max_positions, pad_to_multiple=64)
            got = esm_scoring.masked_marginal_table(model, tokens, **kw)
            with mock.patch.object(esm2, "mha_natural", fa.plain_mha_bthd):
                want = esm_scoring.masked_marginal_table(model, tokens, **kw)
            check_close(f"pppl masked table {name}, kernel vs plain", got, want, TABLE_ATOL, 0.0)
            idx = torch.as_tensor(tokens[1:-1], device=dev)
            tables[name] = float(got[torch.arange(1, len(s) + 1, device=dev), idx].sum())
        err = abs((tables[pppl_mutants[-1]] - tables["WT"]) - pppl_scores[-1])
        print(f"  pppl({pppl_mutants[-1]}) - pppl(WT) from the tables vs the CLI: "
              f"abs err {err:.3e} (atol 1e-3)")
        if err > 1e-3:
            fail("pseudo-ppl score recomputed from the tables differs from the CLI's")
        del model
        torch.cuda.empty_cache()

    score_files = {  # location -> the score rows of the L=250 assay
        "masked": [[m, repr(float(v))] for m, v in zip(mutants, masked_scores)],
        "wt": [[r[0], r[-1]] for r in wt_rows_250[1:]],
        "pppl": [[m, repr(float(v))] for m, v in zip(pppl_mutants, pppl_scores)],
    }
    return {"wt_launches": wt_launches, "pppl_launches": pppl_launches,
            "pppl_mutants": pppl_mutants, "score_files": score_files}


def mixed_mutants(seq: str, n: int):
    """``n`` distinct singles and doubles, alternating, at seeded positions."""
    rs = np.random.RandomState(16)
    out = []
    for i in range(n):
        pos = sorted(rs.choice(len(seq), 1 + i % 2, replace=False))
        out.append(":".join(f"{seq[p]}{p + 1}{AA[(AA.index(seq[p]) + 1 + i) % 20]}"
                            for p in pos))
    return out


SUMMARY_COLUMNS = [
    "Model_rank", "Model_name", "Model type", "Average_{m}", "Bootstrap_standard_error_{m}",
    "Function_Activity", "Function_Binding", "Function_Expression",
    "Function_OrganismalFitness", "Function_Stability", "Low_MSA_depth", "Medium_MSA_depth",
    "High_MSA_depth", "Taxa_Human", "Taxa_Other_Eukaryote", "Taxa_Prokaryote", "Taxa_Virus",
    "Depth_1", "Depth_2", "Depth_3", "Depth_4", "Depth_5+", "Model details", "References"]
METRIC_NAMES = ("Spearman", "AUC", "MCC", "NDCG", "Top_recall")


def run_merge_evaluate(cli, root: Path, device: str, bootstrap: int, tag: str):
    """``merge`` (once) then ``evaluate`` through the CLI; returns the
    evaluate event (walls split into I/O, metrics, bootstrap)."""
    if not (root / "merged").exists():
        rc = cli.main(["merge", "--dms-reference", str(root / "reference.csv"),
                       "--dms-dir", str(root / "dms"), "--scores-root", str(root / "scores"),
                       "--config", str(root / "config.json"), "--output-dir", str(root / "merged")])
        if rc != 0:
            fail(f"merge CLI exited {rc} ({tag})")
    out = root / f"bench_{device}"
    rc = cli.main(["evaluate", "--dms-reference", str(root / "reference.csv"),
                   "--merged-dir", str(root / "merged"), "--config", str(root / "config.json"),
                   "--output-dir", str(out), "--device", device, "--no-html",
                   "--bootstrap-samples", str(bootstrap)])
    if rc != 0:
        fail(f"evaluate CLI exited {rc} ({tag}, {device})")
    for m in METRIC_NAMES:
        summary = out / m / f"Summary_performance_DMS_substitutions_{m}.csv"
        if not summary.exists():
            fail(f"{summary} was not written ({tag})")
        header = read_table(summary)[0]
        if header != [c.format(m=m) for c in SUMMARY_COLUMNS]:
            fail(f"{summary.name}: columns {header} are not the JAX package's order")
    return [json.loads(line) for line in (out / "events.jsonl").open()][-1]


def phase_merge_evaluate_real(cli, wt):
    """12c. merge -> evaluate of the three ESM score files of the L=250 assay."""
    print("[evaluate_real] merge -> evaluate --device cuda of the masked, wt-marginal and "
          "pseudo-ppl ESM2-650M scores (L=250)")
    mutants = wt["pppl_mutants"]
    rs = np.random.RandomState(12)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        (root / "dms").mkdir()
        y = rs.randn(len(mutants))
        write_csv_rows(root / "dms" / "SYNTH_L250.csv", ["mutant", "DMS_score", "DMS_score_bin"],
                       [[m, repr(float(v)), int(v > 0.5)] for m, v in zip(mutants, y)])
        write_reference(root / "reference.csv", [["SYNTH_L250", "SYNTH_L250.csv", "SYNTH",
                                                  "X" * 250, 250, "Human", "Stability",
                                                  "Medium", len(mutants)]])
        config = {}
        column = "esm2_t33_650M_score"
        for loc, rows in wt["score_files"].items():
            (root / "scores" / loc).mkdir(parents=True)
            write_csv_rows(root / "scores" / loc / "SYNTH_L250.csv", ["mutant", column], rows)
            config[f"ESM2_650M_{loc}"] = {"input_score_name": column, "location": loc,
                                          "directionality": 1, "key": "mutant",
                                          "model_type": "Single sequence"}
        (root / "config.json").write_text(json.dumps(
            {"model_list_zero_shot_substitutions_DMS": config}))
        event = run_merge_evaluate(cli, root, "cuda", 1000, "real scores")
        merged = read_table(root / "merged" / "SYNTH_L250.csv")
        if merged[0][-3:] != list(config) or len(merged) != len(mutants) + 1:
            fail(f"merged columns {merged[0]} / {len(merged) - 1} rows do not hold the three "
                 "models")
        rows = read_table(root / "bench_cuda" / "Spearman" /
                          "Summary_performance_DMS_substitutions_Spearman.csv")[1:]
    print(f"  merged {len(mutants)} mutants x {len(config)} models; Summary rows "
          + ", ".join(f"{r[1]} {r[3]}" for r in rows)
          + f"; evaluate {event['seconds']:.3f} s")


EVAL_SELECTION = ("Activity", "Binding", "Expression", "OrganismalFitness", "Stability")
EVAL_TAXA = ("Human", "Eukaryote", "Prokaryote", "Virus")
EVAL_DEPTHS = ("Low", "Medium", "High")


def build_benchmark_world(root: Path, n_assays: int, n_mutants: int, noises) -> None:
    """Synthetic assays cycling through UniProt IDs, selection types, taxa
    and MSA depths, single to 5+ deep mutants, and one score file per model:
    a noisy copy of DMS_score at the model's noise."""
    rs = np.random.RandomState(2024)
    (root / "dms").mkdir()
    refs, config = [], {}
    for j, noise in enumerate(noises):
        name = f"NOISE{j:02d}"  # no "_1".."_4" ending: that marks a depth column
        (root / "scores" / name).mkdir(parents=True)
        config[name] = {"input_score_name": "score", "location": name, "directionality": 1,
                        "key": "mutant", "model_type": f"noise {noise:g}"}
    depth = 1 + np.arange(n_mutants) % 6
    mutants = [":".join(f"A{7 * k + j + 1}G" for j in range(d)) for k, d in enumerate(depth)]
    for i in range(n_assays):
        dms_id = f"SYNTH_{i:03d}"
        y = rs.randn(n_mutants)
        lines = ["mutant,DMS_score,DMS_score_bin"] + [
            f"{m},{v!r},{int(v > 0.7)}" for m, v in zip(mutants, y.tolist())]
        (root / "dms" / f"{dms_id}.csv").write_text("\n".join(lines) + "\n")
        for j, noise in enumerate(noises):
            s = y + noise * rs.randn(n_mutants)
            (root / "scores" / f"NOISE{j:02d}" / f"{dms_id}.csv").write_text(
                "mutant,score\n" + "\n".join(f"{m},{v!r}" for m, v in zip(mutants, s.tolist()))
                + "\n")
        refs.append([dms_id, f"{dms_id}.csv", f"UP{i % 180:03d}", "X" * 10, 10,
                     EVAL_TAXA[i % 4], EVAL_SELECTION[i % 5], EVAL_DEPTHS[i % 3], n_mutants])
    write_reference(root / "reference.csv", refs)
    (root / "config.json").write_text(json.dumps(
        {"model_list_zero_shot_substitutions_DMS": config}))


def compare_outputs(a: Path, b: Path, atol: float) -> int:
    files = sorted(p.relative_to(a) for p in a.rglob("*.csv"))
    if sorted(p.relative_to(b) for p in b.rglob("*.csv")) != files or not files:
        fail(f"{a.name} and {b.name} hold different CSV files")
    for rel in files:
        ra, rb = read_table(a / rel), read_table(b / rel)
        if ra[0] != rb[0] or len(ra) != len(rb):
            fail(f"{rel}: header or row count differs between {a.name} and {b.name}")
        for x, y in zip(ra[1:], rb[1:]):
            for cx, cy in zip(x, y):
                if cx == cy:
                    continue
                try:
                    fx, fy = float(cx), float(cy)
                except ValueError:
                    fail(f"{rel}: {cx!r} vs {cy!r}")
                if not abs(fx - fy) <= atol:
                    fail(f"{rel}: {cx} vs {cy} (atol {atol:g})")
    return len(files)


def phase_evaluate_scale(torch, dev, card, cli):
    """12d. merge -> evaluate through the CLI at the benchmark's assay
    count, once on the card and once on the CPU; the CSVs agree, the
    ranking follows the noise, and the card's metrics match scipy."""
    from scipy.stats import mannwhitneyu, spearmanr

    from proteingym_tpu_torch.metrics import core

    n_assays, n_mutants, noises = EVAL_SCALE
    print(f"[evaluate_scale] merge -> evaluate of {n_assays} synthetic assays x {n_mutants} "
          f"mutants x {len(noises)} models, bootstrap 10,000, --device cuda and cpu")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        build_benchmark_world(root, n_assays, n_mutants, noises)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        events = {"cuda": run_merge_evaluate(cli, root, "cuda", 10000, "scale")}
        merge_eval_s = time.perf_counter() - t0
        events["cpu"] = run_merge_evaluate(cli, root, "cpu", 10000, "scale")
        n_files = compare_outputs(root / "bench_cuda", root / "bench_cpu", 1e-9)
        rows = read_table(root / "bench_cuda" / "Spearman" /
                          "Summary_performance_DMS_substitutions_Spearman.csv")[1:]
        ranking = [r[1] for r in rows]
        if ranking != [f"NOISE{j:02d}" for j in range(len(noises))]:
            fail(f"Average_Spearman ranking {ranking} does not follow the noise order")
        merged = [read_table(root / "merged" / f"SYNTH_{i:03d}.csv")
                  for i in (0, n_assays // 2, n_assays - 1)]
    errs = []
    for table in merged:
        head = table[0]
        cols = {c: np.asarray([float(r[head.index(c)]) for r in table[1:]])
                for c in head if c.startswith(("DMS_", "NOISE"))}
        y, b = cols["DMS_score"], cols["DMS_score_bin"]
        for j in (0, len(noises) - 1):
            s = cols[f"NOISE{j:02d}"]
            rho = float(core.spearman(y, s, device=dev))
            a = float(core.auc(b, s, device=dev))
            u = mannwhitneyu(s[b == 1], s[b == 0]).statistic / ((b == 1).sum() * (b == 0).sum())
            errs += [abs(rho - spearmanr(y, s)[0]), abs(a - u)]
    print(f"  {n_files} CSVs equal between cuda and cpu at 1e-9; Spearman ranking "
          f"{' > '.join(ranking[:3])} ... {ranking[-1]}; card vs scipy spearmanr / mannwhitneyu "
          f"on 3 assays x 2 models: max abs err {max(errs):.3e}")
    if max(errs) > 1e-12:
        fail("the card's Spearman/AUC differ from scipy")
    for device in ("cuda", "cpu"):
        e = events[device]
        other = e["seconds"] - e["io_seconds"] - e["metrics_seconds"] - e["bootstrap_seconds"]
        print(f"  evaluate --device {device}: wall {e['seconds']:.3f} s = I/O "
              f"{e['io_seconds']:.3f} + metrics {e['metrics_seconds']:.3f} + bootstrap "
              f"{e['bootstrap_seconds']:.3f} + aggregation {other:.3f} s; "
              f"{e['seconds'] / (n_assays * n_mutants / 1e4):.4f} s per 10k rows ({card})")
    print(f"  inputs written in {build_s:.2f} s; merge + evaluate (cuda) CLI wall "
          f"{merge_eval_s:.2f} s")


def phase_clinical(cli):
    """12e. evaluate-clinical --device cuda on a synthetic clinical set."""
    print("[evaluate_clinical] evaluate-clinical --device cuda, 12 proteins x 3 models")
    rs = np.random.RandomState(3)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        (root / "merged").mkdir()
        refs = []
        for k in range(12):
            pid = f"NP_{k:06d}.1"
            n = 150 + 10 * k
            labels = rs.randint(0, 2, n)
            cols = {"GOOD": labels + rs.normal(0, 0.7, n), "WEAK": labels + rs.normal(0, 2.5, n),
                    "NOISE": rs.normal(size=n)}
            write_csv_rows(root / "merged" / f"{pid}.csv",
                           ["mutant", "DMS_bin_score", *cols],
                           [[f"A{i + 1}G", int(labels[i]), *(repr(float(c[i]))
                                                            for c in cols.values())]
                            for i in range(n)])
            refs.append([pid, f"{pid}.csv", "A" * n])
        write_csv_rows(root / "clinical.csv", ["protein_id", "DMS_filename", "target_seq"], refs)
        (root / "config.json").write_text(json.dumps({
            "model_list_zero_shot_substitutions_clinical": {
                m: {"input_score_name": m, "location": m, "directionality": 1, "key": "mutant"}
                for m in ("GOOD", "WEAK", "NOISE")}}))
        rc = cli.main(["evaluate-clinical", "--clinical-reference", str(root / "clinical.csv"),
                       "--merged-dir", str(root / "merged"), "--config", str(root / "config.json"),
                       "--output-dir", str(root / "bench"), "--device", "cuda", "--no-html"])
        if rc != 0:
            fail(f"evaluate-clinical CLI exited {rc}")
        summary = read_table(root / "bench" / "AUC" /
                             "Summary_performance_clinical_substitutions_AUC.csv")
        levels = read_table(root / "bench" / "AUC" / "clinical_substitutions_AUC_DMS_level.csv")
    if summary[0] != ["Model_rank", "Model_name", "Model type", "Average_AUC",
                      "Bootstrap_standard_error_AUC"]:
        fail(f"clinical summary columns {summary[0]}")
    if [r[1] for r in summary[1:]] != ["GOOD", "WEAK", "NOISE"] or len(levels) != 13:
        fail(f"clinical summary {summary[1:]} / {len(levels) - 1} proteins are not as expected")
    print("  Summary: " + ", ".join(f"{r[1]} AUC {r[3]} (SE {r[4]})" for r in summary[1:]))


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device; this check runs only on a GPU "
             "(there is no CPU fallback)")
    if not (REPO / "proteingym_tpu_torch").is_dir():
        fail(f"{REPO} is not a checkout of the repository "
             "(proteingym_tpu_torch/ is missing)")
    sys.path.insert(0, str(REPO))

    # ---- 1. device --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not read"
    print(card)
    from proteingym_tpu_torch.ops import _build
    from proteingym_tpu_torch.ops import flash_attention as fa

    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "not installed"
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, triton {triton_version}, "
          f"nvcc: {nvcc[-1] if nvcc else 'not read'}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda", 0)

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all(SOURCES)
    print(f"[build] {', '.join(SOURCES)} ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc, in parallel: " + ", ".join(
              f"{n} {_build.BUILD_SECONDS.get(n, 0.0):.2f} s" for n in SOURCES) + ")")
    for name in SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}:", line.strip())

    # ---- 3. kernel vs plain ----------------------------------------------
    print("[kernel] grouped_attention vs plain reference_mha on the card")
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(b, h, t, d, dtype=torch.bfloat16):
        # (B, T, H, D) memory seen as (B, H, T, D), as the model hands it in
        mk = lambda: torch.randn(b, t, h, d, generator=gen, device=dev).to(dtype)
        return tuple(x.permute(0, 2, 1, 3) for x in (mk(), mk(), mk()))

    def lengths_mask(b, t, lengths):
        return torch.arange(t, device=dev)[None, :] < torch.tensor(lengths, device=dev)[:, None]

    def compare(name, q, k, v, atol=BF16_ATOL, rtol=BF16_RTOL, **kw):
        got = fa.grouped_mha(q, k, v, **kw)
        torch.cuda.synchronize()
        want = fa.plain_mha(q.float(), k.float(), v.float(), **kw)
        if "segment_ids" in kw:  # live rows: padding rows are never consumed
            live = kw["segment_ids"] > 0
            got, want = got.transpose(1, 2)[live], want.transpose(1, 2)[live]
        return check_close(name, got, want, atol, rtol)

    errs = []
    b, h, t, d = 16, 20, 256, 64
    q, k, v = qkv(b, h, t, d)
    mask = lengths_mask(b, t, [252 - 3 * i for i in range(b)])
    headline = dict(key_mask=mask, rope_base=10000.0)
    errs.append(compare("headline B16 H20 T256 D64 mask+rope", q, k, v, **headline))
    q4, k4, v4 = qkv(4, 20, 1024, 64)
    errs.append(compare("T1024 mask+rope", q4, k4, v4,
                        key_mask=lengths_mask(4, 1024, [1024, 1000, 700, 513]),
                        rope_base=10000.0))
    qs, ks, vs = qkv(2, 4, 300, 64)
    seg = torch.zeros(2, 300, dtype=torch.int32, device=dev)
    seg[0, :90], seg[0, 90:200], seg[0, 200:290] = 1, 2, 3
    seg[1, :150], seg[1, 150:260] = 1, 2
    errs.append(compare("segmented mask+rope", qs, ks, vs, key_mask=seg > 0,
                        segment_ids=seg, rope_base=10000.0))
    errs.append(compare("segmented", qs, ks, vs, key_mask=seg > 0, segment_ids=seg))
    qc, kc, vc = qkv(2, 8, 200, 64)
    errs.append(compare("causal", qc, kc, vc, causal=True))
    qa, ka, va = qkv(1, 20, 384, 64)
    slopes = 2.0 ** (-8.0 * torch.arange(1, 21, device=dev) / 20)
    alibi = slopes[:, None] * torch.arange(384, device=dev)[None, :]  # >= 0, up to ~290
    errs.append(compare("ALiBi bias + causal", qa, ka, va, bias=alibi, causal=True))
    qm, km, vm = qkv(2, 4, 100, 32)
    dead = torch.ones(2, 100, dtype=torch.bool, device=dev)
    dead[1] = False  # every key of batch row 1 masked
    errs.append(compare("fully masked row, ragged T=100", qm, km, vm, key_mask=dead))
    for hd in fa.HEAD_DIMS:  # each head dim has its own TMA box and swizzle
        qd, kd, vd = qkv(2, 4, 77, hd)
        errs.append(compare(f"head dim {hd}, T=77 mask+rope", qd, kd, vd,
                            key_mask=lengths_mask(2, 77, [77, 60]), rope_base=10000.0))
        qd, kd, vd = qkv(2, 4, 1037, hd)
        dead = lengths_mask(2, 1037, [1037, 1037])
        dead[1, :150] = False  # rows 0..149 of batch row 1 see no live key
        errs.append(compare(f"head dim {hd}, T=1037 causal, rows with no live key", qd, kd, vd,
                            key_mask=dead, causal=True))
    qf, kf, vf = qkv(2, 4, 100, 32, dtype=torch.float32)
    errs.append(compare("float32 T=100 mask+rope", qf, kf, vf, atol=F32_ATOL,
                        rtol=F32_RTOL, key_mask=lengths_mask(2, 100, [100, 81]),
                        rope_base=10000.0))
    max_abs_err = max(errs)

    t = median_pair(torch, {
        "plain": lambda: fa.plain_mha(q, k, v, **headline),
        "kernel": lambda: fa.grouped_mha(q, k, v, **headline),
    }, reps=5, inner=10, rounds=3)
    ms, plain_ms = t["kernel"], t["plain"]
    print(f"  headline time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(medians of 30 samples of 10 queued calls, {card})")

    # ---- 4. slice: ESM2-650M, L=250, all single mutants --------------------
    from proteingym_tpu_torch.models import esm2, esm_scoring
    from proteingym_tpu_torch.pipeline import cli

    print("[slice] score --model esm --checkpoint esm2_t33_650M, L=250")
    seq, mutants = synth_assay(250, 0)
    seq_long, mutants_long = synth_assay(1100, 1)
    config = esm2.PRESETS["esm2_t33_650M"]
    chunk = 16
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ref, dms_dir = write_assays(root, [("SYNTH_L250", seq, mutants)])
        torch.cuda.reset_peak_memory_stats()
        for name in fa.LAUNCHES:
            fa.LAUNCHES[name] = 0
        t0 = time.perf_counter()
        run_cli(cli, ref, dms_dir, root / "out", "esm2_t33_650M", chunk)
        wall = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        scores = read_scores(root / "out" / "SYNTH_L250.csv",
                             "esm2_t33_650M_score", len(mutants))
    n_fwd = n_chunk_forwards(250, chunk)
    expected = config.num_layers * n_fwd
    print(f"  {len(scores)} finite scores; CLI wall {wall:.2f} s incl. weight init; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  launches {launches} (expected {config.num_layers} layers x {n_fwd} "
          f"forwards = {expected} of K4 and of its rope_qk pre-pass)")
    check_launches("esm slice", launches, {"grouped_attention_bthd": expected,
                                           "rope_qk": expected})

    model = esm2.init_random(config, seed=0, device=dev)
    tokens = esm2.ALPHABET.tokenize(seq)

    def table_and_scores():
        table = esm_scoring.masked_marginal_table(
            model, tokens, chunk=chunk, window=config.max_positions,
            pad_to_multiple=64)
        return table, esm_scoring.score_mutants_from_table(table, mutants, seq)

    table, rescored = table_and_scores()  # warm
    if not np.allclose(rescored, scores, atol=1e-5):
        fail("scores recomputed outside the CLI differ from the CLI's")
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table_and_scores()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    table_s = statistics.median(runs)
    print(f"  table + scores: {table_s:.4f} s median of 3 -> "
          f"{len(mutants) / table_s:.2f} mutants/s ({card})")

    with mock.patch.object(esm2, "mha_natural", fa.plain_mha_bthd):
        table_plain = esm_scoring.masked_marginal_table(
            model, tokens, chunk=32, window=config.max_positions,
            pad_to_multiple=64)
    check_close("table, all 252 rows, kernel vs plain attention",
                table, table_plain, TABLE_ATOL, 0.0)
    del model, table, table_plain
    torch.cuda.empty_cache()

    # ---- 5. windowed path: esm2_t6_8M at L=1100 ---------------------------
    print("[windowed] score --model esm --checkpoint esm2_t6_8M, L=1100")
    small = esm2.PRESETS["esm2_t6_8M"]
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ref, dms_dir = write_assays(root, [("SYNTH_L1100", seq_long, mutants_long)])
        for name in fa.LAUNCHES:
            fa.LAUNCHES[name] = 0
        run_cli(cli, ref, dms_dir, root / "out", "esm2_t6_8M", chunk)
        win_launches = dict(fa.LAUNCHES)
        read_scores(root / "out" / "SYNTH_L1100.csv", "esm2_t6_8M_score",
                    len(mutants_long))
    n_fwd_long = n_chunk_forwards(1100, chunk)
    expected_long = small.num_layers * n_fwd_long
    print(f"  {len(mutants_long)} finite scores; launches {win_launches} "
          f"(expected {small.num_layers} x {n_fwd_long} = {expected_long} of K4 and of rope_qk)")
    check_launches("windowed", win_launches, {"grouped_attention_bthd": expected_long,
                                              "rope_qk": expected_long})

    k5 = phase_cluster_counts(torch, dev, card)
    k2 = phase_long_attention(torch, dev, card, fa, qkv, lengths_mask, check_close)
    poet_run = phase_poet(torch, dev, card, fa, check_close)
    k3_k4 = phase_k3_k4(torch, dev, card, fa, qkv, lengths_mask, check_close)
    packed = phase_packed(torch, card, fa, cli, esm2, scores)
    seg_packed = phase_segment_packed(torch, dev, card, fa, esm2, check_close,
                                      packed["scores"])
    wt = phase_wt_pppl(torch, dev, card, fa, cli, esm2, esm_scoring,
                       (seq, mutants, scores, chunk))
    phase_merge_evaluate_real(cli, wt)
    phase_evaluate_scale(torch, dev, card, cli)
    phase_clinical(cli)

    if "jax" in sys.modules:
        fail("the port imported jax")
    jax_package = sorted(m for m in sys.modules
                         if m == "proteingym_tpu" or m.startswith("proteingym_tpu."))
    if jax_package:
        fail(f"modules of the JAX package were loaded: {jax_package}")
    k1_keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "call_ms")
    measured = {
        # K1's main path is PoET's self tier; the ESM headline shape beside it
        "grouped_attention": dict(
            max_abs_err=max(max_abs_err, k2["k1_self_err"]),
            shape="B8 H16 T4352 D64, 16 segments + causal",
            **{key: k2["k1"][key] for key in k1_keys},
            other_shapes=[{"shape": "B16 H20 T256 D64 mask+rope, pre-pass + loop",
                           "ms": ms, "plain_ms": plain_ms}]),
        "flash_attention": dict(max_abs_err=k2["max_abs_err"], ms=k2["ms"],
                                plain_ms=k2["plain_ms"], library_ms=k2["library_ms"],
                                bound_ms=k2["bound_ms"], bound_by=k2["bound_by"]),
        **k3_k4,
        "cluster_counts": dict(max_abs_err=0.0, **k5),
    }
    by_path = {"esm": launches, "esm_windowed": win_launches,
               "poet": poet_run["launches"], "esm_packed": packed["launches"],
               "esm_segment_packed": seg_packed["launches"], "esm_wt": wt["wt_launches"],
               "esm_pppl": wt["pppl_launches"]}
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": sum(c.get(name, 0) for c in by_path.values()),
        **measured[name],
        "launches_by_path": {path: c.get(name, 0) for path, c in by_path.items()},
    } for name, (source, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
