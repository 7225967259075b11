"""Per-assay score merging (counterpart of proteingym_tpu/merge/, without
pandas; the supervised merge is not ported yet)."""
