"""The port's profile HMM (proteingym_tpu_torch.models.hmm) against the JAX
package's: the estimated parameters (float64), the batched forward with
padding and degenerate residues (float32 on the port's side; the JAX side
runs as its own tests run it, partly in float64 under x64), the doubling
scan of the delete chain against a sequential float64 chain, and the
``hmm`` scorer through both CLIs, on a substitution assay and with
``--indel-mode``."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from proteingym_tpu.models import hmm as jhmm
from proteingym_tpu_torch.models import hmm as thmm

from test_torch_indel import run_both_clis, write_indel_world
from test_torch_retrieval import _cli_world

# float64 on both sides: only summation orders differ
PARAM_ATOL = 1e-12
# forward log-odds of ~20-80 residues, float32 recursion against JAX's
FORWARD_ATOL = 1e-3
AA = "ACDEFGHIKLMNPQRSTVWY"


def _alignment(rs, n, length, gap=0.15):
    focus = rs.randint(1, 21, length)
    rows = np.tile(focus, (n, 1))
    sub = rs.rand(n, length) < 0.3
    rows[sub] = rs.randint(1, 21, sub.sum())
    rows[rs.rand(n, length) < gap] = 0
    rows[0] = focus
    return rows.astype(np.int8)


@pytest.mark.parametrize("weighted", [False, True])
def test_build_profile_hmm_equals_jax(weighted):
    rs = np.random.RandomState(0)
    matrix = _alignment(rs, 300, 45)
    matrix[rs.rand(300) < 0.9, 7] = 0  # a column of 90% gaps
    weights = rs.rand(300) if weighted else None
    got = thmm.build_profile_hmm(matrix, weights)
    want = jhmm.build_profile_hmm(matrix, weights)
    np.testing.assert_allclose(got.log_e_match, want.log_e_match, atol=PARAM_ATOL, rtol=0)
    np.testing.assert_allclose(got.log_bg, want.log_bg, atol=PARAM_ATOL, rtol=0)
    assert sorted(got.log_a) == sorted(want.log_a)
    for k in want.log_a:
        np.testing.assert_allclose(got.log_a[k], want.log_a[k], atol=PARAM_ATOL, rtol=0)
    assert got.L == want.L == 45


def test_encode_equals_jax():
    seq = "ACDXBZUOacdw" + AA
    np.testing.assert_array_equal(thmm._encode(seq), jhmm._encode(seq))


def _variants(rs, focus, n):
    out = []
    for i in range(n):
        s = list(focus)
        for _ in range(rs.randint(0, 4)):
            s[rs.randint(len(s))] = AA[rs.randint(20)]
        at = rs.randint(0, len(s))
        if i % 3 == 1:
            del s[at:at + rs.randint(1, 6)]
        elif i % 3 == 2:
            s[at:at] = [AA[j] for j in rs.randint(0, 20, rs.randint(1, 6))]
        if i % 5 == 0 and s:
            s[rs.randint(len(s))] = "X"  # degenerate: emitted from the background
        out.append("".join(s))
    return out


@pytest.mark.parametrize("length", [1, 2, 17, 60])
def test_batched_forward_equals_jax(length):
    rs = np.random.RandomState(length)
    matrix = _alignment(rs, 200, length)
    model_t = thmm.build_profile_hmm(matrix, rs.rand(200))
    # the same parameters on both sides: this holds the forward alone
    model_j = jhmm.ProfileHMM(model_t.log_e_match, model_t.log_bg, model_t.log_a)
    focus = "".join(AA[c - 1] for c in matrix[0])
    seqs = _variants(rs, focus, 24) + [focus, focus[:1], "X" * 3, focus + focus]
    got = thmm.score_sequences(model_t, seqs, device="cpu")
    want = jhmm.score_sequences(model_j, seqs)
    assert got.dtype == np.float64 and got.shape == (len(seqs),)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=FORWARD_ATOL, rtol=0)


def test_padding_freezes_a_row():
    rs = np.random.RandomState(3)
    model = thmm.build_profile_hmm(_alignment(rs, 100, 30))
    short, long = "ACDEFGHIK", "ACDEFGHIKLMNPQRSTVWYACDEFGHIK"
    tokens = torch.from_numpy(np.stack([np.r_[thmm._encode(short), [-1] * 20],
                                        thmm._encode(long)]))
    alone = [thmm.forward_logprob(model, torch.from_numpy(thmm._encode(s)[None]))
             for s in (short, long)]
    both = thmm.forward_logprob(model, tokens)  # 20 padding steps after the short row
    np.testing.assert_array_equal(both.numpy(), torch.cat(alone).numpy())


@pytest.mark.parametrize("length", [1, 2, 3, 31, 64, 257, 1000])
def test_doubling_scan_equals_a_sequential_float64_chain(length):
    rs = np.random.RandomState(length)
    # DD log-probs of a long profile: their running sum reaches ~-1e4 over
    # 1,000 columns, where C + logcumsumexp(u - C) would lose ~1e-3
    c = np.log(rs.uniform(1e-5, 1.0, length))
    c[0] = 0.0
    u = np.where(rs.rand(length) < 0.3, thmm.NEG_BIG, rs.randn(length) * 50 - 100)
    want = np.empty(length)
    want[0] = u[0]
    for j in range(1, length):
        want[j] = np.logaddexp(u[j], want[j - 1] + c[j])
    for dtype, atol in ((torch.float64, 1e-9), (torch.float32, 2e-4)):
        got = thmm.delete_chain(torch.tensor(u, dtype=dtype)[None],
                                thmm.doubling_levels(torch.tensor(c, dtype=dtype)))[0]
        live = want > -1e29
        np.testing.assert_allclose(got.double().numpy()[live], want[live], atol=atol, rtol=1e-6)
        assert (got.double().numpy()[~live] < -1e29).all()
    assert len(thmm.doubling_levels(torch.tensor(c))) == int(np.ceil(np.log2(length)))


def test_hmm_scorer_equals_jax_on_substitutions(tmp_path):
    target, _ = _cli_world(tmp_path)
    port, want = run_both_clis(tmp_path, "hmm", indel=False)
    assert port[0] == want[0] and port[0][-1] == "HMM_score"
    assert [r[:-1] for r in port] == [r[:-1] for r in want]
    got = np.asarray([float(r[-1]) for r in port[1:]])
    np.testing.assert_allclose(got, [float(r[-1]) for r in want[1:]], atol=FORWARD_ATOL, rtol=0)
    assert np.isfinite(got).all() and got[-1] == 0.0  # the WT row's own mutant string


def test_hmm_scorer_equals_jax_in_indel_mode(tmp_path):
    target, seqs = write_indel_world(tmp_path, seed=17)
    port, want = run_both_clis(tmp_path, "hmm")
    assert port[0] == want[0] == ["mutant", "mutated_sequence", "DMS_score", "DMS_score_bin",
                                  "HMM_score"]
    assert [r[:-1] for r in port] == [r[:-1] for r in want]
    got = np.asarray([float(r[-1]) for r in port[1:]])
    np.testing.assert_allclose(got, [float(r[-1]) for r in want[1:]], atol=FORWARD_ATOL, rtol=0)
    assert np.isfinite(got).all() and got[-1] == 0.0 and seqs[-1] == target
