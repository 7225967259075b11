"""The port's RSALOR (proteingym_tpu_torch.models.rsalor) and its weighted
column counts (msa/columns.py) against the JAX package's: the burial
proxy, the fitted log frequencies with and without a structure and
weights, the scores, and the ``rsalor`` scorer through both CLIs with and
without --structure-dir."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from proteingym_tpu.models import gemme as jgemme
from proteingym_tpu.models import rsalor as jrsalor
from proteingym_tpu_torch.data.structures import synthetic_helix_backbone
from proteingym_tpu_torch.models import rsalor as trsalor
from proteingym_tpu_torch.msa.columns import column_counts

from test_torch_gemme import (
    AA, alignment, run_clis, score_column, write_baseline_world, write_structure,
)

# float64 on both sides; the weighted column sums run in another order
TABLE_ATOL = 1e-10


@pytest.mark.parametrize("weighted", [True, False])
def test_column_counts_equal_the_one_hot_contraction(weighted):
    rs = np.random.RandomState(0)
    matrix = alignment(rs, 300, 50)
    weights = rs.rand(300) if weighted else None
    want, _ = jgemme._column_stats(matrix, np.ones(300) if weights is None else weights, 20)
    got = column_counts(matrix, weights, device="cpu")
    assert got.dtype == np.float64 and got.shape == (50, 20)
    np.testing.assert_allclose(got, want, atol=TABLE_ATOL, rtol=0)
    # a column of gaps only counts nothing
    matrix[:, 4] = 0
    assert (column_counts(matrix, weights, device="cpu")[4] == 0).all()


@pytest.mark.parametrize("with_structure", [True, False])
@pytest.mark.parametrize("weighted", [True, False])
def test_fit_and_score_equal_jax(with_structure, weighted):
    rs = np.random.RandomState(3)
    matrix = alignment(rs, 250, 45)
    weights = rs.rand(250) if weighted else None
    coords = synthetic_helix_backbone(45, seed=1) if with_structure else None
    got = trsalor.fit_rsalor(matrix, weights, coords=coords, device="cpu")
    want = jrsalor.fit_rsalor(matrix, weights, coords=coords)
    np.testing.assert_allclose(got.log_freq, want.log_freq, atol=TABLE_ATOL, rtol=0)
    np.testing.assert_array_equal(got.rsa, want.rsa)
    assert got.gamma == want.gamma and got.alphabet == want.alphabet
    if with_structure:
        assert 0 < got.rsa.min() < got.rsa.max() <= 1  # the helix ends are less buried
    focus = "".join(AA[c - 1] for c in matrix[0])
    mutants = [f"{focus[p]}{p + 1}{a}" for p in range(45) for a in "CHW" if a != focus[p]]
    mutants += [f"{mutants[0]}:{mutants[-1]}", "WT"]
    np.testing.assert_allclose(trsalor.score_mutants(got, focus, mutants),
                               jrsalor.score_mutants(want, focus, mutants), atol=1e-9, rtol=0)
    with pytest.raises(ValueError, match="WT mismatch"):
        trsalor.score_mutants(got, focus, [f"{'A' if focus[0] != 'A' else 'C'}1D"])


def test_rsa_from_structure_equals_jax():
    coords = synthetic_helix_backbone(80, seed=5)
    np.testing.assert_array_equal(trsalor.rsa_from_structure(coords),
                                  jrsalor.rsa_from_structure(coords))
    np.testing.assert_array_equal(trsalor.rsa_from_structure(coords, radius=6.0, max_neighbors=8),
                                  jrsalor.rsa_from_structure(coords, radius=6.0, max_neighbors=8))


@pytest.mark.parametrize("with_structure", [True, False])
def test_rsalor_scorer_writes_the_jax_cli_file(tmp_path, with_structure):
    target, _ = write_baseline_world(tmp_path, n_rows=300, seed=4)
    pdbs = write_structure(tmp_path, target) if with_structure else None
    port, want = run_clis(tmp_path, "rsalor", structure_dir=pdbs)
    assert port[0] == want[0] and port[0][-1] == "RSALOR_score"  # the registry merges "RSALOR"
    assert [r[:-1] for r in port] == [r[:-1] for r in want]
    got = score_column(port)
    np.testing.assert_allclose(got, score_column(want), atol=1e-9, rtol=0)
    assert np.isnan(got[-3:-1]).all() and got[-1] == 0.0
    assert np.isfinite(got[:-3]).all()


def test_column_counts_on_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        column_counts(np.ones((2, 3), np.int8), device="cuda")
