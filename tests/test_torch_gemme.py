"""The port's GEMME and ESCOTT (proteingym_tpu_torch.models.gemme) against
the JAX package's: the fitted tables on the tree path (3 sampled trees)
and the surrogate path (``use_tree=False``, and fewer than 4 rows), with
alpha and method; the scores in every mode; ESCOTT's landscape extraction
and alignment sanitising; and the ``gemme`` and ``escott`` scorers through
both CLIs, ``escott`` with a structure in --structure-dir and with one of
the wrong length. ``write_baseline_world`` is the assay the other
alignment-baseline tests share."""

import contextlib
import csv

import numpy as np
import pytest

pytest.importorskip("jax")

from proteingym_tpu.models import gemme as jgemme
from proteingym_tpu.pipeline import cli as jcli
from proteingym_tpu_torch.data.structures import synthetic_helix_backbone, write_pdb_backbone
from proteingym_tpu_torch.models import gemme as tgemme
from proteingym_tpu_torch.pipeline import cli as tcli

AA = "ACDEFGHIKLMNPQRSTVWY"
# float64 on both sides; the weighted column sums run in another order
TABLE_ATOL = 1e-10


def alignment(rs, n, length, gap=0.1, focus=None):
    """An (n, length) code matrix (0 gap, 1..20) around a focus row (row 0),
    with duplicated rows, an all-gap row and some rows far from the focus."""
    focus = rs.randint(1, 21, length) if focus is None else focus
    rows = np.tile(focus, (n, 1))
    rate = rs.uniform(0.05, 0.7, n)[:, None]
    sub = rs.rand(n, length) < rate
    rows[sub] = rs.randint(1, 21, sub.sum())
    rows[rs.rand(n, length) < gap] = 0
    rows[0] = focus
    if n > 8:
        rows[3] = rows[5]
        rows[7] = 0
    return rows.astype(np.int8)


def write_baseline_world(tmp_path, n_rows=600, length=44, covered=30, seed=0, indel=False):
    """An assay on a length-44 target whose alignment (n_rows rows) covers
    residues 4-33: single and double substitutions, a synonymous one as the
    WT row and mutants off the alignment, or with ``indel`` whole sequences
    with insertions and deletions (the WT last); the reference CSV. Returns
    (target, mutants)."""
    rs = np.random.RandomState(seed)
    target = "".join(AA[i] for i in rs.randint(0, 20, length))
    focus = np.asarray([AA.index(c) + 1 for c in target[3:3 + covered]])
    msa = alignment(rs, n_rows, covered, focus=focus)
    (tmp_path / "msa").mkdir()
    with open(tmp_path / "msa" / "FAM.a2m", "w") as f:
        for i, row in enumerate(msa):
            seq = "".join("-" if c == 0 else AA[c - 1] for c in row)
            f.write(f">FAM/4-33\n{seq}\n" if i == 0 else f">h{i}/1-{covered}\n{seq}\n")
    if indel:
        mutants = []
        for i in range(30):
            s = list(target)
            at = rs.randint(0, length)
            if i % 3 == 0:
                del s[at:at + rs.randint(1, 4)]
            elif i % 3 == 1:
                s[at:at] = [AA[j] for j in rs.randint(0, 20, rs.randint(1, 4))]
            else:
                s[at] = AA[(AA.index(s[at]) + 1 + rs.randint(19)) % 20]
            mutants.append("".join(s))
        mutants.append(target)
        columns = ["mutant", "mutated_sequence", "DMS_score", "DMS_score_bin"]
        rows = [[m, m, i, i % 2] for i, m in enumerate(mutants)]
    else:
        mutants = []
        for p in range(3, 3 + covered, 2):
            for to in rs.choice(list(AA.replace(target[p], "")), 3, replace=False):
                mutants.append(f"{target[p]}{p + 1}{to}")
        for _ in range(10):
            p, r = sorted(rs.choice(np.arange(3, 3 + covered), 2, replace=False))
            mutants.append(f"{target[p]}{p + 1}{AA[(AA.index(target[p]) + 5) % 20]}:"
                           f"{target[r]}{r + 1}{AA[(AA.index(target[r]) + 7) % 20]}")
        mutants += [f"{target[0]}1{AA[(AA.index(target[0]) + 1) % 20]}",  # off the alignment
                    f"{target[40]}41{AA[(AA.index(target[40]) + 2) % 20]}",
                    f"{target[10]}11{target[10]}"]  # synonymous: the WT row
        columns = ["mutant", "DMS_score", "DMS_score_bin"]
        rows = [[m, i, i % 2] for i, m in enumerate(mutants)]
    with open(tmp_path / "ref.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["DMS_id", "DMS_filename", "UniProt_ID", "target_seq", "seq_len",
                    "MSA_filename", "MSA_start", "MSA_end", "MSA_theta", "weight_file_name"])
        w.writerow(["FAM_B", "FAM_B.csv", "P1", target, length, "FAM.a2m", 4, 33, 0.2,
                    "FAM.npy"])
    (tmp_path / "dms").mkdir()
    with open(tmp_path / "dms" / "FAM_B.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(columns)
        w.writerows(rows)
    return target, mutants


def write_structure(tmp_path, target, stem="P1", length=None):
    """A synthetic helix backbone of the target (or of ``length`` residues)
    as <stem>.pdb in tmp_path/pdb."""
    (tmp_path / "pdb").mkdir(exist_ok=True)
    n = len(target) if length is None else length
    write_pdb_backbone(tmp_path / "pdb" / f"{stem}.pdb", synthetic_helix_backbone(n, seed=3),
                       (target * 2)[:n])
    return tmp_path / "pdb"


def run_clis(tmp_path, model, extra=(), structure_dir=None, indel=False,
             jax_context=contextlib.nullcontext):
    """``score`` through the port's CLI (cpu) and the JAX CLI (inside
    ``jax_context()``) on the baseline world; returns the two CSVs' rows."""
    common = ["--model", model, "--msa-dir", str(tmp_path / "msa"), "--weights-dir",
              str(tmp_path / "w"), "--dms-reference", str(tmp_path / "ref.csv"), "--dms-dir",
              str(tmp_path / "dms"), "--quiet"]
    common += (["--structure-dir", str(structure_dir)] if structure_dir else []) + (
        ["--indel-mode"] if indel else []) + (["--extra", *extra] if extra else [])
    assert tcli.main(["score", "--device", "cpu", "--output-dir", str(tmp_path / "port"),
                      "--fail-fast"] + common) == 0
    with jax_context():
        assert jcli.main(["--platform", "cpu", "score", "--output-dir", str(tmp_path / "jax"),
                          "--fail-fast"] + common) == 0
    out = {}
    for side in ("port", "jax"):
        with open(tmp_path / side / "FAM_B.csv", newline="") as f:
            out[side] = list(csv.reader(f))
    return out["port"], out["jax"]


def score_column(rows):
    return np.asarray([float(r[-1]) if r[-1] != "" else np.nan for r in rows[1:]])


@pytest.mark.parametrize("n,use_tree,method", [
    (900, None, "tree"),      # 3 trees of 512 sampled rows
    (300, None, "tree"),      # one tree over every row
    (300, False, "surrogate"),
    (3, None, "surrogate"),   # fewer than 4 rows
])
@pytest.mark.parametrize("weighted", [True, False])
def test_fit_gemme_equals_jax(n, use_tree, method, weighted):
    rs = np.random.RandomState(n)
    matrix = alignment(rs, n, 40)
    weights = rs.rand(n) if weighted else None
    got = tgemme.fit_gemme(matrix, weights, use_tree=use_tree, device="cpu")
    want = jgemme.fit_gemme(matrix, weights, use_tree=use_tree)
    assert got.method == want.method == method
    assert got.alpha == want.alpha
    np.testing.assert_array_equal(got.wt_codes, want.wt_codes)
    for name in ("pred_epi", "pred_ind", "conservation"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), atol=TABLE_ATOL,
                                   rtol=0)
    focus = "".join(AA[c - 1] for c in matrix[0])
    mutants = [f"{focus[p]}{p + 1}{a}" for p in range(0, 40, 3) for a in "AKW" if a != focus[p]]
    to = {p: AA[(AA.index(focus[p]) + 4) % 20] for p in (1, 9)}
    mutants += [f"{focus[1]}2{to[1]}:{focus[9]}10{to[9]}", "WT", ""]
    for mode in ("combined", "epistatic", "independent"):
        np.testing.assert_allclose(tgemme.score_mutants(got, focus, mutants, mode=mode),
                                   jgemme.score_mutants(want, focus, mutants, mode=mode),
                                   atol=4 * TABLE_ATOL, rtol=0)


def test_gemme_device_statistics_equal_numpy():
    import torch

    rs = np.random.RandomState(4)
    matrix = alignment(rs, 200, 30)
    m = torch.as_tensor(matrix)
    np.testing.assert_array_equal(tgemme._p_distance_to_query(m, 0).numpy(),
                                  jgemme._p_distance_to_query(matrix, matrix[0]))
    dist = rs.rand(200)
    np.testing.assert_array_equal(
        tgemme._min_carrier_distance(m, torch.as_tensor(dist), 20).numpy(),
        jgemme._min_carrier_distance(matrix, dist, 20))


def test_escott_extraction_and_alignment_parsing_equal_jax():
    rs = np.random.RandomState(1)
    land = rs.randn(30, 20)
    mutants = ["A3C", "C1D:E30W", "K12K"]
    assert tgemme.escott_extract_scores(land, mutants, 1) == jgemme.escott_extract_scores(
        land, mutants, 1)
    assert tgemme.escott_extract_scores(land, ["A13C"], 11) == jgemme.escott_extract_scores(
        land, ["A13C"], 11)
    lines = [">sp_P1.2/1-30\n", "acd..EF\n", "GH-k\n", ">x.y_z\n", "MN.p\n"]
    assert tgemme.escott_parse_alignment(lines) == jgemme.escott_parse_alignment(lines)


@pytest.mark.parametrize("model,column", [("gemme", "GEMME_score"), ("escott", "ESCOTT_score")])
def test_scorers_write_the_jax_cli_file(tmp_path, model, column):
    target, mutants = write_baseline_world(tmp_path)
    port, want = run_clis(tmp_path, model)
    assert port[0] == want[0] == ["mutant", "DMS_score", "DMS_score_bin", "mutated_sequence",
                                  column]
    assert [r[:-1] for r in port] == [r[:-1] for r in want]
    got, ref = score_column(port), score_column(want)
    np.testing.assert_allclose(got, ref, atol=4 * TABLE_ATOL, rtol=0)
    assert np.isnan(got[-3:-1]).all() and got[-1] == 0.0  # off the alignment; the WT row
    assert np.isfinite(got[:-3]).all()


@pytest.mark.parametrize("mode", ["epistatic", "independent"])
def test_escott_modes_and_structure_equal_jax(tmp_path, mode):
    target, _ = write_baseline_world(tmp_path, n_rows=200, seed=1)
    pdbs = write_structure(tmp_path, target)
    port, want = run_clis(tmp_path, "escott", extra=[f"mode={mode}"], structure_dir=pdbs)
    plain = tmp_path / "plain"
    plain.mkdir()
    for name in ("msa", "dms", "ref.csv"):
        (plain / name).symlink_to(tmp_path / name)
    unmodulated, _ = run_clis(plain, "escott", extra=[f"mode={mode}"])
    got, ref = score_column(port), score_column(want)
    np.testing.assert_allclose(got, ref, atol=4 * TABLE_ATOL, rtol=0)
    live = np.isfinite(got) & (got != 0)
    assert live.sum() > 40
    assert not np.allclose(got[live], score_column(unmodulated)[live])  # the RSA weights apply


def test_escott_structure_of_the_wrong_length_is_skipped(tmp_path, capsys):
    target, _ = write_baseline_world(tmp_path, n_rows=200, seed=2)
    pdbs = write_structure(tmp_path, target, stem="FAM_B", length=40)
    port, want = run_clis(tmp_path, "escott", structure_dir=pdbs)
    message = "escott/FAM_B: structure length 40 != target 44; skipping RSA modulation"
    assert capsys.readouterr().out.count(message) == 2  # both CLIs
    np.testing.assert_allclose(score_column(port), score_column(want), atol=4 * TABLE_ATOL,
                               rtol=0)
