#!/usr/bin/env python3
"""Split the float32 attention kernel's time by part, on one NVIDIA GPU.

    python3 tools/torch_f32_attention_profile.py

``nsys`` and ``ncu`` do not run where the card is, so the kernel
(``grouped_attention_f32_kernel`` in
``proteingym_tpu_torch/ops/csrc/grouped_attention.cuh``) is profiled by
ablation. Each variant is a copy of ``proteingym_tpu_torch/ops/csrc``
with one part of the kernel taken out, built by nvcc into its own
directory under ``.scratch/`` (git-ignored):

- ``as built``: the source as it is, held to the plain version within
  1e-4 at every shape;
- ``one TF32 pass``: the two small-term passes of each product dropped
  (a 1xTF32 kernel: what the split costs on the tensor cores);
- ``no split pass``: K/V tiles staged but never split into fragments
  (both loops);
- ``no q.k^T``, ``no p.v``: either product dropped;
- ``no K/V copies``: the cp.async copies of the K/V tiles dropped;
- ``no q prologue``: q never loaded or split;
- ``one sum``: the small terms added into the big terms' sums, as the
  tensor cores accumulate them (no separate small-term sums);
- ``rescale every tile``: O rescaled on every tile, not only when a
  row's max moved.

The last two compute the function; the others compute garbage and are
only timed. Prints the card's name and power limit, each variant's
registers and spill stores per head dim (ptxas), for ``as built`` and
``one sum`` the float64 referee of tests/test_torch_cuda_kernels.py
(the kernel's largest error against float64 over the plain float32
version's, causal and full, T=256, at every head dim), then at the AR
zoo's causal float32 shapes
(B32 T256: H16 D256, H16 D128, H20 D64, H24 D96, H16 D160; B32 H16 T416
D128) SDPA ``is_causal`` on the same tensors and each variant's best of 3
rounds in alternating order (CUDA events, 20 queued calls). Needs an
NVIDIA GPU and nvcc.
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

S_LOOP = "#pragma unroll\n    for (int kk = 0; kk < NK; ++kk) {\n      const uint4 qa"
Q_LOOP = "    for (int kk = 0; kk < NK; ++kk) {\n      const int c = 8 * kk + 2 * t4;\n      x[kk]"
VARIANTS = {  # name -> (text in grouped_attention.cuh, its replacement) pairs
    "as built": [],
    "one TF32 pass": [
        ("  for (int n = 0; n < N; ++n) mma_tf32(small[n], a_lo, b[n].x, b[n].y);", ""),
        ("  for (int n = 0; n < N; ++n) mma_tf32(small[n], a_hi, b[n].z, b[n].w);", "")],
    "no split pass": [("for (int e = tid; e < NJ * NK * 32; e += kThreads)",
                       "for (int e = tid; e < 0; e += kThreads)")],
    "no q.k^T": [(S_LOOP, S_LOOP.replace("kk < NK", "kk < 0"))],
    "no p.v": [("        mma_3xtf32(big, small, a_hi, a_lo, vb);", "")],
    "no K/V copies": [("      cp_async16(is_v ? v_raw + j * RV + c : k_raw + j * RK + c, src, "
                       "k0 + j < p.T);", "")],
    "no q prologue": [(Q_LOOP, Q_LOOP.replace("kk < NK", "kk < 0")),
                      ("      store_q(kk, make_float2(", "      if (false) store_q(kk, make_float2(")],
    "one sum": [("mma_tf32(small[n], a_lo,", "mma_tf32(big[n], a_lo,"),
                ("mma_tf32(small[n], a_hi,", "mma_tf32(big[n], a_hi,")],
    "rescale every tile": [
        ("    if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {", "    {")],
}
REFEREE = ("as built", "one sum")
SHAPES = ((32, 16, 256, 256), (32, 16, 256, 128), (32, 20, 256, 64), (32, 24, 256, 96),
          (32, 16, 256, 160), (32, 16, 416, 128))


def build(name, edits, build_mod, fa, source):
    """The variant of the sources in ``source``, built and loaded with the
    wrapper's argument types; prints its registers and spills per D."""
    root = REPO / ".scratch" / ("f32_profile_" + re.sub(r"\W+", "_", name))
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(source, root / "csrc")
    header = root / "csrc" / "grouped_attention.cuh"
    text = header.read_text()
    for old, new in edits:  # every occurrence (the split pass has two loops)
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
          + " ".join(f"D{d}:{r}/{s}" for d, r, s in sorted(per_d)), flush=True)
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    from proteingym_tpu_torch.ops import _build
    from proteingym_tpu_torch.ops import flash_attention as fa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full float32
    source = _build.CSRC
    libs = {name: build(name, edits, _build, fa, source) for name, edits in VARIANTS.items()}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    for name in REFEREE:
        fa._kernel_lib = lambda lib=libs[name]: lib
        ratios = []
        for d in fa.F32_HEAD_DIMS:
            worst = 0.0
            for causal in (True, False):
                q, k, v = (torch.randn(2, 256, 4, d, generator=gen, device=dev).transpose(1, 2)
                           for _ in range(3))
                s = q.double() @ k.double().transpose(-1, -2) / d ** 0.5
                if causal:
                    s = s.masked_fill(torch.ones(256, 256, dtype=torch.bool, device=dev).triu(1),
                                      float("-inf"))
                want = torch.softmax(s, dim=-1) @ v.double()
                err = float((fa.grouped_mha(q, k, v, causal=causal).double() - want).abs().max())
                plain = float((fa.plain_mha(q, k, v, causal=causal).double() - want).abs().max())
                worst = max(worst, err / plain)
            ratios.append(f"D{d} {worst:.2f}")
        print(f"{name}: error against float64 over the plain version's, " + ", ".join(ratios),
              flush=True)

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
        fa._kernel_lib = lambda lib=libs["as built"]: lib
        err = float((fa.grouped_mha(q, k, v, causal=True) - want).abs().max())
        if err > 1e-4:
            raise SystemExit(f"as built at B{b} H{h} T{t} D{d}: max |diff| {err:.3g}")
        sdpa = min(time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True)) for _ in range(3))
        best = {name: float("inf") for name in libs}
        for rnd in range(3):
            for name in (list(libs) if rnd % 2 == 0 else list(libs)[::-1]):
                fa._kernel_lib = lambda lib=libs[name]: lib
                best[name] = min(best[name], time_ms(lambda: fa.grouped_mha(q, k, v, causal=True)))
        print(f"B{b} H{h} T{t} D{d} causal, ms: SDPA is_causal {sdpa:.4f}, "
              + ", ".join(f"{name} {ms:.4f}" for name, ms in best.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
