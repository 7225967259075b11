"""Tensor ops: the hand-written Hopper attention kernel and plain PyTorch
versions (counterpart of proteingym_tpu.ops)."""
