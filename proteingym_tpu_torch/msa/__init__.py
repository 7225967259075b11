"""Alignments: A2M parsing and preprocessing, sequence weights on the
hand-written Hopper kernel (counterpart of proteingym_tpu.msa)."""
