"""The port's raw-assay cleanup (data/cleanup.py, no pandas) against the JAX
``dms_file_cleanup`` on synthetic raw CSVs: silent duplicates (averaged),
bad tokens, NA and non-numeric scores, infinities, out-of-range and
WT-mismatched positions, multi-mutants, another start index and
``directionality = -1``. Mutants, sequences and order exactly; scores
within 1e-12 relative (pandas' CSV float parser is not correctly rounded,
the port parses with ``float()``)."""

import numpy as np
import pytest

from proteingym_tpu.data.cleanup import dms_file_cleanup as jax_cleanup
from proteingym_tpu_torch.data.cleanup import dms_file_cleanup
from proteingym_tpu_torch.data.table import Table

TARGET = "MKLVAGDEFWYHCPRST"


def _raw_csv(path, seed, start_idx, mutant_column="mutant", phenotype="score"):
    rs = np.random.RandomState(seed)
    rows = []
    for _ in range(150):
        pos = int(rs.randint(0, len(TARGET)))
        mt = "ACDEFGHIKLMNPQRSTVWY"[rs.randint(20)]
        mutant = f"{TARGET[pos]}{pos + start_idx}{mt}"
        if rs.rand() < 0.15:
            p2 = (pos + 3) % len(TARGET)
            mutant += f":{TARGET[p2]}{p2 + start_idx}A"
        score = repr(float(rs.randn() * 3))
        rows.append((mutant, score))
    rows += [  # the quirks
        ("X9Z", "1.0"), ("bad", "2.0"), ("", "1.5"), ("NA", "1.0"),
        (f"{TARGET[0]}{start_idx}A", "oops"), (f"{TARGET[1]}{1 + start_idx}C", ""),
        (f"{TARGET[2]}{2 + start_idx}D", "inf"), (f"{TARGET[3]}{3 + start_idx}E", "NaN"),
        (f"{TARGET[4]}{4 + start_idx}F", "-1e3"), (f"{TARGET[4]}{4 + start_idx}F", "7"),
        (f"{TARGET[5]}{len(TARGET) + start_idx}A", "1.0"),  # past the end
        (f"W{start_idx}A", "1.0"),  # wrong WT letter
        (f"{TARGET[0]}{start_idx - 1}A" if start_idx > 1 else "M0A", "1.0"),
        (f"{TARGET[6]}{6 + start_idx}G", "1_000"),  # not a number to pandas
        (f"{TARGET[7]}+{7 + start_idx}G", "1.0"),
    ]
    with open(path, "w") as f:
        f.write(f"{mutant_column},{phenotype},other\n")
        for i, (m, s) in enumerate(rows):
            f.write(f"{m},{s},{i}\n")


@pytest.mark.parametrize("seed,start_idx,direction", [(0, 1, 1), (1, 1, -1), (2, 5, -1),
                                                      (3, 1, 1)])
def test_cleanup_matches_jax(tmp_path, seed, start_idx, direction):
    path = tmp_path / "raw.csv"
    _raw_csv(path, seed, start_idx)
    got = dms_file_cleanup(path, TARGET, start_idx=start_idx, directionality=direction)
    want = jax_cleanup(path, TARGET, start_idx=start_idx, directionality=direction)
    assert isinstance(got, Table) and got.names == list(want.columns)
    assert got["mutant"].tolist() == want["mutant"].tolist()
    assert got["mutated_sequence"].tolist() == want["mutated_sequence"].tolist()
    np.testing.assert_allclose(got["DMS_score"], want["DMS_score"].to_numpy(), rtol=1e-12,
                               atol=0)
    assert len(set(got["mutant"].tolist())) == len(got) > 50  # duplicates averaged


def test_cleanup_columns_and_end_idx(tmp_path):
    path = tmp_path / "raw.csv"
    _raw_csv(path, 4, 1, mutant_column="variant", phenotype="fitness")
    kw = dict(mutant_column="variant", phenotype_name="fitness", end_idx=10)
    got = dms_file_cleanup(path, TARGET, **kw)
    want = jax_cleanup(path, TARGET, **kw)
    assert got["mutant"].tolist() == want["mutant"].tolist()
    np.testing.assert_allclose(got["DMS_score"], want["DMS_score"].to_numpy(), rtol=1e-12)
    assert all(int(t[1:-1]) <= 10 for m in got["mutant"] for t in m.split(":"))


def test_cleanup_of_a_table_and_the_reference_example():
    raw = Table({"mutant": ["M1A", "K2C", "K2C", "X9Z", "M1A:K2C", "bad", None, "L3P"],
                 "score": ["1.0", "2.0", "4.0", "5.0", "3.0", "1.0", "1.0", "oops"]})
    out = dms_file_cleanup(raw, "MKLV")
    assert out["mutant"].tolist() == ["K2C", "M1A", "M1A:K2C"]
    assert out["DMS_score"].tolist() == [3.0, 1.0, 3.0]
    assert out["mutated_sequence"].tolist() == ["MCLV", "AKLV", "ACLV"]
    empty = dms_file_cleanup(Table({"mutant": ["bad"], "score": ["1"]}), "MKLV")
    assert len(empty) == 0 and empty.names == ["mutant", "mutated_sequence", "DMS_score"]
