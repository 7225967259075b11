"""Model families ported to PyTorch (counterpart of proteingym_tpu.models)."""
