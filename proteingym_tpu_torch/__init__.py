"""proteingym_tpu_torch — the PyTorch/CUDA port of proteingym_tpu.

The JAX package ``proteingym_tpu`` is the reference; this package mirrors
its module names so each counterpart is easy to find, and holds every
ported path to the reference in parity tests (tests/test_torch_*.py).

Runtime rule: nothing here imports ``jax``, ``pandas`` or the JAX
package's ``data``/``models``/``ops`` modules, because the GPU host has
none of jax and pandas. The two stdlib-only JAX-package modules
``proteingym_tpu.pipeline.manifest`` and ``proteingym_tpu.pipeline.telemetry``
are shared rather than copied.

Layout (the slice ported so far: ESM masked-marginal scoring):
  data/      — mutant parsing, optimal windows, reference CSV (stdlib/numpy)
  ops/       — attention (hand-written Hopper kernel + plain version),
               rotary tables, gather-then-log-softmax
  models/    — ESM2/ESM-1b/ESM-1v as an nn.Module, masked-marginal scoring
  pipeline/  — checkpoint specs, the ``esm`` scorer, the ``score`` CLI
"""

__version__ = "0.1.0"
