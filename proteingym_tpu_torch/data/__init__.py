"""Assay data helpers (numpy/stdlib counterparts of proteingym_tpu.data)."""
