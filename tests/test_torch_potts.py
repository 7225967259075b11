"""The port's Potts and site-independent models (proteingym_tpu_torch.
models.potts) against the JAX package's: dE in float64 (singles, multiples,
WT rows, invalid mutants as NaN, the offset), plmc ``.model`` files
written by one side and read by the other, the site-independent trainer
(float64), the pseudolikelihood trainer (float32 Adam, 30 steps), and the
``site_independent``, ``potts`` and ``evmutation`` scorers through both
CLIs."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from proteingym_tpu.models import potts as jpotts
from proteingym_tpu_torch.models import potts as tpotts

from test_torch_indel import run_both_clis
from test_torch_retrieval import _cli_world

ALPHABET = "-ACDEFGHIKLMNPQRSTVWY"
# float64 on both sides: only summation orders differ
DE_ATOL = 1e-10
# the trained fields and couplings: float32 Adam on both sides, the same
# updates in another summation order
PLM_ATOL = 1e-4
# site-independent frequencies and fields, float64
SI_ATOL = 1e-12
# dE of a trained Potts model: a sum of ~2L trained fields and couplings
# (L = 30 focus columns), each within PLM_ATOL of JAX's
PLM_SCORE_ATOL = 1e-3


def _random_pair(seed, length=12, q=21):
    rs = np.random.RandomState(seed)
    h = rs.normal(size=(length, q))
    J = rs.normal(size=(length, length, q, q)) * 0.1
    J = 0.5 * (J + np.transpose(J, (1, 0, 3, 2)))
    J[np.arange(length), np.arange(length)] = 0.0
    f = rs.rand(length, q)
    f /= f.sum(axis=1, keepdims=True)
    target = "".join(ALPHABET[1 + i] for i in rs.randint(0, 20, length))
    kw = dict(h=h, J=J, alphabet=ALPHABET, index_list=np.arange(5, 5 + length),
              target_seq=target, f_i=f, neff=123.4, weights=rs.rand(50))
    return tpotts.PottsModel(**kw), jpotts.PottsModel(**kw)


def _mutants(rs, model, n, max_depth=4):
    out = []
    for i in range(n):
        picks = sorted(rs.choice(model.L, 1 + i % max_depth, replace=False))
        toks = []
        for p in picks:
            wt = model.target_seq[p]
            toks.append(f"{wt}{model.index_list[p]}{ALPHABET[1 + rs.randint(20)]}")
        out.append(":".join(toks))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_delta_hamiltonians_equal_jax(seed):
    tm, jm = _random_pair(seed)
    rs = np.random.RandomState(seed)
    muts = _mutants(rs, tm, 40) + ["WT", "", "A99C", f"{tm.target_seq[0]}5X", "A5C:A99C",
                                   f"{tm.target_seq[0]}5-"]
    got = tm.delta_hamiltonians(muts, device="cpu")
    want = jm.delta_hamiltonians(muts)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=DE_ATOL, rtol=0)
    assert np.isnan(got[-4:-1]).all() and (got[40:42] == 0).all() and np.isfinite(got[-1])
    np.testing.assert_allclose(tm.wt_background(device="cpu"), jm.wt_background(),
                               atol=DE_ATOL, rtol=0)


def test_offset_and_independent_model_equal_jax():
    tm, jm = _random_pair(2)
    rs = np.random.RandomState(2)
    muts = _mutants(rs, tm, 20)
    shifted = [":".join(f"{t[0]}{int(t[1:-1]) + 30}{t[-1]}" for t in m.split(":")) for m in muts]
    got = tm.delta_hamiltonians(shifted, offset=-30, device="cpu")
    np.testing.assert_allclose(got, jm.delta_hamiltonians(shifted, offset=-30), atol=DE_ATOL)
    np.testing.assert_allclose(got, tm.delta_hamiltonians(muts, device="cpu"), atol=DE_ATOL)
    ti, ji = tm.to_independent_model(), jm.to_independent_model()
    assert not ti.J.any()
    np.testing.assert_allclose(ti.delta_hamiltonians(muts, device="cpu"),
                               ji.delta_hamiltonians(muts), atol=DE_ATOL, rtol=0)


def _assert_same_fields(a, b, atol=0.0):
    assert (a.alphabet, a.target_seq, a.L, a.q) == (b.alphabet, b.target_seq, b.L, b.q)
    np.testing.assert_array_equal(a.index_list, b.index_list)
    for name in ("h", "J", "f_i", "weights"):
        np.testing.assert_allclose(getattr(a, name), getattr(b, name), atol=atol, rtol=0)
    assert (a.theta, a.neff) == (b.theta, b.neff)
    np.testing.assert_array_equal(a._f_ij, b._f_ij)


def test_plmc_files_cross_read(tmp_path):
    tm, jm = _random_pair(3)
    jpotts.write_plmc_model(jm, tmp_path / "jax.model")
    tpotts.write_plmc_model(tm, tmp_path / "port.model")
    assert (tmp_path / "jax.model").read_bytes() == (tmp_path / "port.model").read_bytes()
    from_jax = tpotts.read_plmc_model(tmp_path / "jax.model")
    _assert_same_fields(from_jax, jpotts.read_plmc_model(tmp_path / "jax.model"))
    _assert_same_fields(jpotts.read_plmc_model(tmp_path / "port.model"), from_jax)
    np.testing.assert_allclose(from_jax.J, tm.J, atol=1e-6)  # float32 on disk
    # a model read with its f_ij writes them back
    tpotts.write_plmc_model(from_jax, tmp_path / "again.model")
    assert (tmp_path / "again.model").read_bytes() == (tmp_path / "jax.model").read_bytes()


def _matrix(seed, n, length, q=21):
    rs = np.random.RandomState(seed)
    focus = rs.randint(1, q, length)
    rows = np.tile(focus, (n, 1))
    sub = rs.rand(n, length) < 0.35
    rows[sub] = rs.randint(0, q, sub.sum())
    rows[:, 3] = np.where(rows[:, 2] % 2 == 0, 4, 9)  # a coupled pair of columns
    return rows.astype(np.int8), rs.rand(n) + 0.1


def test_train_site_independent_equals_jax():
    matrix, w = _matrix(4, 300, 20)
    args = (ALPHABET, np.arange(1, 21), "".join(ALPHABET[c] for c in matrix[0]))
    got = tpotts.train_site_independent(matrix, w, *args)
    want = jpotts.train_site_independent(matrix, w, *args)
    for name in ("h", "f_i", "J"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), atol=SI_ATOL, rtol=0)
    assert got.neff == pytest.approx(want.neff, abs=1e-12)


def test_train_potts_plm_equals_jax():
    matrix, w = _matrix(5, 64, 12)
    args = (ALPHABET, np.arange(1, 13), "".join(ALPHABET[c] for c in matrix[0]))
    got = tpotts.train_potts_plm(matrix, w, *args, steps=30, device="cpu")
    want = jpotts.train_potts_plm(matrix, w, *args, steps=30)
    np.testing.assert_allclose(got.h, want.h, atol=PLM_ATOL, rtol=0)
    np.testing.assert_allclose(got.J, want.J, atol=PLM_ATOL, rtol=0)
    np.testing.assert_allclose(got.f_i, want.f_i, atol=SI_ATOL, rtol=0)
    assert np.abs(got.J).max() > 0.05  # the couplings moved
    np.testing.assert_array_equal(got.J, np.transpose(got.J, (1, 0, 3, 2)))
    assert not got.J[np.arange(12), np.arange(12)].any()
    assert got.losses.shape == (30,) and got.losses[-1] < got.losses[0]


@pytest.mark.parametrize("model,extra", [("site_independent", []), ("potts", ["plm_steps=25"]),
                                         ("evmutation", ["plm_steps=25"])])
def test_scorers_equal_jax(tmp_path, model, extra):
    _cli_world(tmp_path)
    with open(tmp_path / "dms" / "FAM_T.csv", "a") as f:  # outside the alignment: NaN
        f.write("A44C,x,0\nWT,y,0\n")
    port, want = run_both_clis(tmp_path, model, extra, indel=False)
    column = "Site_Independent_score" if model == "site_independent" else "EVmutation_score"
    assert port[0] == want[0] and port[0][-1] == column
    assert [r[:-1] for r in port] == [r[:-1] for r in want]
    cells = [r[-1] for r in port[1:]]
    # NaN (outside the alignment's residues 4-33) as an empty field, as
    # pandas writes it
    outside = [not 4 <= int(r[0][1:-1]) <= 33 for r in port[1:-1]]
    assert [c == "" for c in cells[:-1]] == outside == [r[-1] == "" for r in want[1:-1]]
    assert cells[-1] == "0.0" == want[-1][-1] and outside.count(False) >= 5
    got = np.asarray([float(c) if c else np.nan for c in cells])
    atol = DE_ATOL if model == "site_independent" else PLM_SCORE_ATOL
    np.testing.assert_allclose(got, [float(r[-1]) if r[-1] else np.nan for r in want[1:]],
                               atol=atol, rtol=0)


def test_potts_scorer_reads_a_plmc_checkpoint(tmp_path):
    _cli_world(tmp_path)
    tm, _ = _random_pair(6, length=30)
    # the alignment's focus columns are residues 4-33 of the target
    rows = list(open(tmp_path / "dms" / "FAM_T.csv"))[1:]
    target = open(tmp_path / "ref.csv").read().splitlines()[1].split(",")[3]
    tm = tpotts.PottsModel(h=tm.h, J=tm.J, alphabet=ALPHABET, index_list=np.arange(4, 34),
                           target_seq=target[3:33], f_i=tm.f_i, neff=tm.neff, weights=tm.weights)
    tpotts.write_plmc_model(tm, tmp_path / "m.model")
    port, want = run_both_clis(tmp_path, "potts", checkpoint=str(tmp_path / "m.model"),
                               indel=False)
    assert [r[:-1] for r in port] == [r[:-1] for r in want] and len(port) == len(rows) + 1
    got = np.asarray([float(r[-1]) if r[-1] else np.nan for r in port[1:]])
    np.testing.assert_allclose(got, [float(r[-1]) if r[-1] else np.nan for r in want[1:]],
                               atol=DE_ATOL, rtol=0)
    assert np.isfinite(got[:-1]).sum() >= 5
