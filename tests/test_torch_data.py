"""The port's data helpers (numpy/stdlib) against proteingym_tpu.data."""

import math

import numpy as np
import pytest

from proteingym_tpu.data import mutants as jmut
from proteingym_tpu.data import reference as jref
from proteingym_tpu.data import windows as jwin
from proteingym_tpu_torch.data import mutants as tmut
from proteingym_tpu_torch.data import reference as tref
from proteingym_tpu_torch.data import windows as twin


@pytest.mark.parametrize("window", [48, 47, 1023, 1024])
@pytest.mark.parametrize("seq_len", [10, 47, 48, 49, 70, 1100])
def test_optimal_window_matches(window, seq_len):
    for pos in sorted({0, 1, seq_len // 2, window // 2 - 1, window // 2,
                       seq_len - window // 2 - 1, seq_len - window // 2, seq_len - 1}):
        if 0 <= pos < seq_len:
            assert twin.get_optimal_window(pos, seq_len, window) == \
                jwin.get_optimal_window(pos, seq_len, window)


@pytest.mark.parametrize("mutant", [
    "A1P", "A1P:D2N", "", "WT", " wt ", None, float("nan"), "M10W:K3R:Q1E",
])
def test_is_wt_row_and_parse_match(mutant):
    assert tmut.is_wt_row(mutant) == jmut.is_wt_row(mutant)
    if mutant is None or isinstance(mutant, float):
        return
    assert tmut.parse_mutant(mutant) == jmut.parse_mutant(mutant)


@pytest.mark.parametrize("bad", ["A1", "Ax2P"])
def test_parse_rejects_like_jax(bad):
    with pytest.raises(ValueError) as got:
        tmut.parse_mutant(bad)
    with pytest.raises(ValueError) as want:
        jmut.parse_mutant(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mutant,start", [
    ("M1A", 1), ("K2R:T3S", 1), ("", 1), ("WT", 1), ("K3R", 2), ("A5C", 1),
    ("M1Z", 1), ("M9A", 1),
])
def test_apply_mutant_matches(mutant, start):
    seq = "MKTAYIAK"

    def run(fn):
        try:
            return fn(seq, mutant, start_idx=start)
        except ValueError as e:
            return ("error", str(e))

    assert run(tmut.apply_mutant) == run(jmut.apply_mutant)


@pytest.mark.parametrize("start,max_depth", [(1, None), (2, None), (1, 4)])
def test_mutations_to_arrays_matches(start, max_depth):
    muts = ["K2R", "T3S:Y5W", "", "WT", "M1A:K2C:T3D"]
    if start == 2:
        muts = ["K2R", "T3S:Y5W", "WT"]
    got = tmut.mutations_to_arrays(muts, max_depth=max_depth, start_idx=start)
    want = jmut.mutations_to_arrays(muts, max_depth=max_depth, start_idx=start)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_load_reference_matches(tmp_path):
    path = tmp_path / "ref.csv"
    path.write_text(
        "DMS_id,DMS_filename,UniProt_ID,target_seq,seq_len,MSA_start,taxon\n"
        "A_1,A_1.csv,P1,MKTAYIAK,8,1,Human\n"
        "B_2,,P2,GLIEV,,,\n"
        "C_3,C_3.csv,P3,DNLSGQ,6,2,Virus\n"
    )
    got, want = tref.load_reference(path), jref.load_reference(path)
    assert len(got) == len(want) == 3
    assert [r.DMS_id for r in got] == want.dms_ids
    for i, dms_id in enumerate(want.dms_ids):
        for key in (i, dms_id):
            g, w = got[key], want[key]
            assert (g.DMS_id, g.DMS_filename, g.UniProt_ID, g.target_seq, g.seq_len) == \
                (w.DMS_id, w.DMS_filename, w.UniProt_ID, w.target_seq, w.seq_len)
    with pytest.raises(KeyError):
        got["Z_9"]
    assert got["C_3"].raw["taxon"] == "Virus"
    assert not math.isnan(got[1].seq_len)
