#!/usr/bin/env python3
"""Variants of the float32 attention kernel's launch constants, timed in
turns on one NVIDIA GPU.

    python3 tools/torch_f32_attention_variants.py

Each variant is a copy of ``proteingym_tpu_torch/ops/csrc`` with one or two
constants of ``grouped_attention.cuh`` replaced, built by nvcc into its own
directory under ``.scratch/`` (git-ignored): the source as it is, 4 or 16
keys an online-softmax update (``kF32Step``), three blocks an SM below
D=128 (``__launch_bounds__``), and 128-thread blocks. For each it prints
the compiler's registers and spill stores of every head dim, then, at the
AR zoo's causal float32 shapes (B32 T256: H16 D256, H16 D128, H20 D64,
H24 D96, H16 D160; B32 H16 T416 D128), each variant's best of 3 rounds in
alternating order (CUDA events, 20 queued calls), every output held to
the plain version within 1e-4 first. Prints the card's name and power
limit first. Needs an NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

VARIANTS = {  # name -> (text in grouped_attention.cuh, its replacement) pairs
    "as is": [],
    "4 keys an update": [("constexpr int kF32Step = 8;", "constexpr int kF32Step = 4;")],
    "16 keys an update": [("constexpr int kF32Step = 8;", "constexpr int kF32Step = 16;")],
    "3 blocks an SM below D=128": [
        ("__launch_bounds__(kF32Threads, D >= 256 ? 1 : 2)",
         "__launch_bounds__(kF32Threads, D >= 256 ? 1 : (D >= 128 ? 2 : 3))")],
    "128-thread blocks": [
        ("constexpr int kF32Threads = 256;", "constexpr int kF32Threads = 128;"),
        ("__launch_bounds__(kF32Threads, D >= 256 ? 1 : 2)",
         "__launch_bounds__(kF32Threads, D >= 256 ? 2 : 4)")],
}
SHAPES = ((32, 16, 256, 256), (32, 16, 256, 128), (32, 20, 256, 64), (32, 24, 256, 96),
          (32, 16, 256, 160), (32, 16, 416, 128))


def build(name, edits, build_mod, fa, source):
    """The variant of the sources in ``source``, built and loaded with the
    wrapper's argument types."""
    root = REPO / ".scratch" / ("f32_variant_" + re.sub(r"\W+", "_", name))
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(source, root / "csrc")
    header = root / "csrc" / "grouped_attention.cuh"
    text = header.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{name}: {old!r} is not in grouped_attention.cuh")
        text = text.replace(old, new)
    header.write_text(text)
    build_mod.CSRC, build_mod.BUILD_DIR = root / "csrc", root / "build"
    build_mod._LOADED.clear()
    fa._kernel_lib.cache_clear()
    t0 = time.perf_counter()
    lib = fa._kernel_lib()
    log = build_mod.build_log("grouped_attention").splitlines()
    per_d = []
    for i, line in enumerate(log):
        m = re.search(r"grouped_attention_f32_kernelILi(\d+)E", line)
        if m and "Compiling" in line:
            info = " ".join(log[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", info)
            spill = re.search(r"(\d+) bytes spill stores", info)
            per_d.append((int(m.group(1)), regs.group(1) if regs else "?",
                          spill.group(1) if spill else "?"))
    print(f"{name}: built in {time.perf_counter() - t0:.1f} s; registers/spill bytes "
          + " ".join(f"D{d}:{r}/{s}" for d, r, s in sorted(per_d)))
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    from proteingym_tpu_torch.ops import _build
    from proteingym_tpu_torch.ops import flash_attention as fa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    source = _build.CSRC
    libs = {name: build(name, edits, _build, fa, source) for name, edits in VARIANTS.items()}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def time_ms(fn, n=20):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    for b, h, t, d in SHAPES:
        q, k, v = (torch.randn(b, t, h, d, generator=gen, device=dev).transpose(1, 2)
                   for _ in range(3))
        want = fa.reference_mha(q, k, v, causal=True)
        best = {name: float("inf") for name in libs}
        for rnd in range(3):
            for name in (list(libs) if rnd % 2 == 0 else list(libs)[::-1]):
                fa._kernel_lib = lambda lib=libs[name]: lib
                err = float((fa.grouped_mha(q, k, v, causal=True) - want).abs().max())
                if err > 1e-4:
                    raise SystemExit(f"{name} at B{b} H{h} T{t} D{d}: max |diff| {err:.3g}")
                best[name] = min(best[name], time_ms(lambda: fa.grouped_mha(q, k, v, causal=True)))
        print(f"B{b} H{h} T{t} D{d} causal, ms: "
              + ", ".join(f"{name} {ms:.4f}" for name, ms in best.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
