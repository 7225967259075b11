"""Benchmark metrics, aggregation and clinical evaluation (counterpart of
proteingym_tpu/metrics/, without pandas; the supervised evaluation is
not ported yet)."""
