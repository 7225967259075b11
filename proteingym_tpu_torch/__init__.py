"""proteingym_tpu_torch — the PyTorch/CUDA port of proteingym_tpu.

The JAX package ``proteingym_tpu`` is the reference; this package mirrors
its module names so each counterpart is easy to find, and holds every
ported path to the reference in parity tests (tests/test_torch_*.py).

Runtime rule: nothing here imports ``jax``, ``pandas`` or any module of
the JAX package ``proteingym_tpu``, not even its stdlib-only ones: the GPU
host has neither jax nor pandas, and the port stands alone. What it needs
from the JAX package it keeps as its own copy (``constants.py``,
``pipeline/manifest.py``, ``pipeline/telemetry.py``, ``configs/*.json``),
held equal to the original by tests/test_torch_shared_copies.py.

Layout:
  data/      — mutant parsing, optimal windows, reference CSV, registry,
               CSV tables (stdlib/numpy)
  msa/       — A2M parsing, sequence weights (hand-written Hopper kernel)
  ops/       — attention (hand-written Hopper kernels + plain versions),
               rotary tables, gather-then-log-softmax
  models/    — ESM2/ESM-1b/ESM-1v and PoET as nn.Modules, masked-marginal,
               packed, WT-marginal and pseudo-ppl scoring
  merge/, metrics/ — merge and evaluate without pandas
  pipeline/  — checkpoint specs, scorers, the CLI
"""

__version__ = "0.1.0"
