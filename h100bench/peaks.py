"""The table of peaks and the least time a piece of work can take.

The peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity,
at the full 700 W). ``bound`` is copied from ``chip_smoke.py``'s ``bound``
(its arithmetic unchanged) so that a later change to that script cannot
move the yardstick.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12  # dense bf16 / fp16 on the tensor cores
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # HBM3


def bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    """The least time the card could take for work of ``flops`` operations
    at ``peak`` per second (bf16 unless given) and ``nbytes`` of memory
    traffic, and which side sets it. Copied from ``chip_smoke.bound``."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
