"""The alphabets and benchmark vocabulary the port uses (counterpart of
proteingym_tpu/constants.py; tests/test_torch_shared_copies.py holds each
value equal to the JAX package's).

Semantics match the reference's shared constants
(ref: proteingym/utils/scoring_utils.py:5-7, proteingym/utils/msa_utils.py:17-22).
"""

# Canonical 20-letter amino-acid vocabulary, alphabetical by one-letter code.
AA_VOCAB = "ACDEFGHIKLMNPQRSTVWY"

GAP = "-"

ALPHABET_PROTEIN_NOGAP = AA_VOCAB
ALPHABET_PROTEIN_GAP = GAP + AA_VOCAB

# Benchmark aggregation vocabulary (ref: performance_DMS_benchmarks.py:339-348).
MUTATION_DEPTHS = ("1", "2", "3", "4", "5+")
METRICS = ("Spearman", "AUC", "MCC", "NDCG", "Top_recall")
