#!/usr/bin/env python3
"""Drive the PyTorch port once on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure raises, and the script exits non-zero):

1. device: the card's name and power limit (nvidia-smi), torch/CUDA
   versions; TF32 is switched off for matmuls and cuDNN.
2. build: nvcc builds the attention kernel from ops/csrc at first use.
3. kernel: the Hopper attention kernel against the plain PyTorch version
   on the card, in every mode the slice and its successors use, and both
   timed at the ESM2-650M headline shape.
4. slice: ``score --model esm --checkpoint esm2_t33_650M`` (seeded random
   bf16 weights, full width and depth) on a synthetic L=250 assay with all
   4,750 single mutants, through the port's CLI; the launch counter must
   show 33 kernel launches per chunk forward; the whole log-prob table is
   recomputed with the plain attention and compared.
5. windowed: ``esm2_t6_8M`` on an L=1100 assay, through the CLI, so every
   row takes the optimal-window path at T=1024.

It prints one JSON line describing the kernels, then, as its last line,
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
KERNEL_SOURCE = "proteingym_tpu_torch/ops/csrc/grouped_attention.cu"
REPLACES = "proteingym_tpu/ops/flash_attention.py:181"

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


def synth_assay(seq_len: int, seed: int):
    rs = np.random.RandomState(seed)
    seq = "".join(AA[i] for i in rs.randint(0, 20, seq_len))
    mutants = [f"{seq[p]}{p + 1}{m}" for p in range(seq_len) for m in AA
               if m != seq[p]]
    return seq, mutants


def write_assays(root: Path, assays):
    """A reference CSV plus one DMS CSV per (DMS_id, seq, mutants)."""
    dms_dir = root / "dms"
    dms_dir.mkdir()
    ref = root / "reference.csv"
    with open(ref, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["DMS_id", "DMS_filename", "UniProt_ID", "target_seq", "seq_len"])
        for dms_id, seq, _ in assays:
            w.writerow([dms_id, f"{dms_id}.csv", "SYNTH", seq, len(seq)])
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


def n_chunk_forwards(seq_len, chunk, pad_to_multiple=64):
    """Forwards masked_marginal_table runs for L residues (L+2 tokens), on
    the short and the windowed path alike: rows bucketed to the pad
    multiple, then cut into chunks."""
    total = seq_len + 2
    rows = -(-total // pad_to_multiple) * pad_to_multiple
    return -(-rows // chunk)


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
    fa._kernel_lib()
    print(f"[build] grouped_attention ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.BUILD_SECONDS.get('grouped_attention', 0.0):.2f} s)")
    for line in _build.build_log("grouped_attention").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

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
    for hd in (16, 24, 32):
        qd, kd, vd = qkv(2, 4, 77, hd)
        errs.append(compare(f"head dim {hd}, T=77 mask+rope", qd, kd, vd,
                            key_mask=lengths_mask(2, 77, [77, 60]), rope_base=10000.0))
    qf, kf, vf = qkv(2, 4, 100, 32, dtype=torch.float32)
    errs.append(compare("float32 T=100 mask+rope", qf, kf, vf, atol=F32_ATOL,
                        rtol=F32_RTOL, key_mask=lengths_mask(2, 100, [100, 81]),
                        rope_base=10000.0))
    max_abs_err = max(errs)

    kernel_call = lambda: fa.grouped_mha(q, k, v, **headline)
    plain_call = lambda: fa.plain_mha(q, k, v, **headline)
    for fn in (kernel_call, plain_call):  # warm up
        fn()
    torch.cuda.synchronize()
    times = {"kernel": [], "plain": []}
    for order in (("plain", "kernel"), ("kernel", "plain")) * 3:
        for which in order:
            times[which] += time_ms(torch, kernel_call if which == "kernel" else plain_call, 5)
    ms = statistics.median(times["kernel"])
    plain_ms = statistics.median(times["plain"])
    print(f"  headline time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(medians of {len(times['kernel'])} samples of 10 queued calls, {card})")

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
          f"forwards = {expected})")
    if launches["grouped_attention"] != expected:
        fail(f"grouped_attention launched {launches['grouped_attention']} times, "
             f"expected {expected}")

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

    with mock.patch.object(esm2, "mha", fa.plain_mha):
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
        win_launches = fa.LAUNCHES["grouped_attention"]
        read_scores(root / "out" / "SYNTH_L1100.csv", "esm2_t6_8M_score",
                    len(mutants_long))
    n_fwd_long = n_chunk_forwards(1100, chunk)
    expected_long = small.num_layers * n_fwd_long
    print(f"  {len(mutants_long)} finite scores; launches {win_launches} "
          f"(expected {small.num_layers} x {n_fwd_long} = {expected_long})")
    if win_launches != expected_long:
        fail(f"windowed run launched {win_launches} kernels, expected {expected_long}")

    if "jax" in sys.modules:
        fail("the port imported jax")
    print(json.dumps({"kernels": [{
        "name": "grouped_attention",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": launches["grouped_attention"],
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
