"""The VESPA family and the supervised track on the card against the CPU:
ProtT5's encoder, decoder and masked log-odds table (plain float32
attention, no kernel of the port), ProteinNPT's Adam steps on the same
draws, Kermut's fit and predictions, the ridge's out-of-fold predictions,
the ConsCNN and VespaG's heads, and the embedding ridge's features through
K4 at ESM2's shape against the plain attention.

Every test needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The file imports neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_supervised_cuda.py
"""

from unittest import mock

import numpy as np
import pytest
import torch

from proteingym_tpu_torch.data.structures import synthetic_helix_backbone
from proteingym_tpu_torch.models import esm2, kermut, prot_t5, protein_npt, supervised_baselines
from proteingym_tpu_torch.models import vespa_heads, vespag
from proteingym_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

AA = "ACDEFGHIKLMNPQRSTVWY"
# float32 without TF32 on both devices, summation order apart, through 2
# layers; a planted fault (T5's missing softmax scale put in) moves them O(0.1)
F32_ATOL = 1e-4
# the ridge's float32 Cholesky (cuSOLVER against LAPACK) of a 481-wide Gram
RIDGE_ATOL = 1e-3
# 5 Adam steps on the same draws: rounding only, ~1e-6 per parameter
STEP_ATOL = 1e-4
# Kermut's fit: 20 Adam steps at lr 0.1 through a float32 Cholesky
FIT_ATOL = 1e-3
# bf16 ESM2 features, K4 against the plain attention, mean-pooled
BF16_FEAT_ATOL = 5e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _scaled(q, k, v, bias, attend=prot_t5._attend):
    return attend(q * q.shape[-1] ** -0.5, k, v, bias)


def test_prot_t5_card_matches_cpu(dev):
    c = prot_t5.PRESETS["prot_t5_tiny"]
    cpu = prot_t5.init_random(c, seed=3, device="cpu", decoder_layers=2)
    card = prot_t5.load_state_dict(cpu.state_dict(), device=dev)
    seq = "".join(np.random.RandomState(3).choice(list(AA), 40))
    want = prot_t5.masked_logodds(cpu, seq, chunk=16)
    got = prot_t5.masked_logodds(card, seq, chunk=16)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(prot_t5.embeddings(card, seq).cpu().numpy(),
                               prot_t5.embeddings(cpu, seq).numpy(), atol=F32_ATOL, rtol=0)
    with mock.patch.object(prot_t5, "_attend", _scaled):
        bad = prot_t5.masked_logodds(card, seq, chunk=16)
    assert np.abs(bad - want).max() > 10 * F32_ATOL


def test_vespa_heads_card_match_cpu(dev):
    rs = np.random.RandomState(4)
    emb = torch.from_numpy(rs.randn(60, 64).astype(np.float32))
    cons_cpu = vespa_heads.init_conscnn(d_model=64, seed=1, device="cpu")
    cons = vespa_heads.load_conscnn_state_dict(
        {k.replace("conv1", "0").replace("conv2", "3"): v[..., None] if v.dim() == 3 else v
         for k, v in cons_cpu.state_dict().items()}, device=dev)
    np.testing.assert_allclose(vespa_heads.conservation_probs(cons, emb.to(dev)),
                               vespa_heads.conservation_probs(cons_cpu, emb), atol=1e-5, rtol=0)
    head = vespag.init_fnn(64, hidden_dim=32, seed=2, device="cpu")
    teacher = rs.randn(60, 20).astype(np.float32)
    want = vespag.landscape(vespag.train_from_teacher(head, emb, teacher, steps=5), emb)
    card = vespag.load_state_dict(vespag.state_dict_of(head), device=dev)
    got = vespag.landscape(vespag.train_from_teacher(card, emb.to(dev), teacher, steps=5),
                           emb.to(dev))
    np.testing.assert_allclose(got, want, atol=STEP_ATOL, rtol=0)


def _assay(n=300, length=24, seed=5):
    rs = np.random.RandomState(seed)
    seq = "".join(rs.choice(list(AA), length))
    seqs, muts = [], []
    for _ in range(n):
        p = rs.randint(length)
        a = AA[(AA.index(seq[p]) + 1 + rs.randint(19)) % 20]
        muts.append(f"{seq[p]}{p + 1}{a}")
        seqs.append(seq[:p] + a + seq[p + 1:])
    return seq, muts, seqs, rs.randn(n)


def test_ridge_card_matches_cpu(dev):
    seq, muts, seqs, y = _assay()
    x = supervised_baselines.onehot_features(seqs, len(seq))
    x = np.concatenate([x, np.random.RandomState(6).randn(len(y), 1).astype(np.float32)], 1)
    folds = supervised_baselines.assign_folds(muts, "fold_random_5")
    want = supervised_baselines.ridge_cv_predict(x, y, folds, device="cpu")
    got = supervised_baselines.ridge_cv_predict(x, y, folds, device=dev)
    np.testing.assert_allclose(got, want, atol=RIDGE_ATOL, rtol=0)
    bad = supervised_baselines.ridge_cv_predict(x, y, folds, lam=1e-3, device=dev)
    assert np.abs(bad - want).max() > 10 * RIDGE_ATOL


def test_protein_npt_steps_card_match_cpu(dev):
    c = protein_npt.ProteinNptConfig(embed_dim=48, steps=5)
    seq, muts, seqs, y = _assay(n=120)
    feats = protein_npt.residue_features(seqs, len(seq))
    aux = np.random.RandomState(7).randn(len(y))
    cpu = protein_npt.init_random(c, seed=1, device="cpu")
    card = protein_npt.load_state_dict(cpu.state_dict(), c, device=dev)
    draws = list(protein_npt.draw_batches(c, len(y), c.steps,
                                          torch.Generator().manual_seed(3)))
    cpu, n_cpu = protein_npt.train(cpu, c, feats, y, aux=aux, draws=draws)
    card, n_card = protein_npt.train(card, c, feats, y, aux=aux,
                                     draws=[(i.to(dev), h.to(dev)) for i, h in draws])
    np.testing.assert_allclose(n_card["losses"], n_cpu["losses"], atol=STEP_ATOL, rtol=0)
    want, got = cpu.state_dict(), card.state_dict()
    for key in want:
        if key.endswith(".k.bias"):  # zero gradient but for rounding: Adam's +-lr noise
            continue
        np.testing.assert_allclose(got[key].cpu().numpy(), want[key].numpy(), atol=STEP_ATOL,
                                   rtol=0, err_msg=key)
    tr = np.arange(len(y)) < 90
    norm = {"mu": float(np.mean(y[tr])), "sd": float(np.std(y[tr]) + 1e-8)}
    np.testing.assert_allclose(
        protein_npt.predict(card, c, norm, feats[tr], y[tr], feats[~tr], aux[tr], aux[~tr]),
        protein_npt.predict(cpu, c, norm, feats[tr], y[tr], feats[~tr], aux[tr], aux[~tr]),
        atol=STEP_ATOL, rtol=0)


def test_kermut_fit_card_matches_cpu(dev):
    seq, muts, _, y = _assay(n=200, length=40, seed=8)
    coords = synthetic_helix_backbone(len(seq), seed=8)
    probs = np.random.RandomState(8).dirichlet(np.ones(20), len(seq))
    data = kermut.KermutData.build(probs, coords[:, 1])
    enc = kermut.encode_variants(muts)
    train, test = tuple(t[:160] for t in enc), tuple(t[160:] for t in enc)
    want_h = kermut.fit(data, train, y[:160], steps=20, device="cpu")
    got_h = kermut.fit(data, train, y[:160], steps=20, device=dev)
    for k in want_h:
        assert abs(float(got_h[k]) - float(want_h[k])) < FIT_ATOL, k
    want = kermut.predict(want_h, data, train, y[:160], test, device="cpu")
    got = kermut.predict(got_h, data, train, y[:160], test, device=dev)
    np.testing.assert_allclose(got, want, atol=FIT_ATOL, rtol=0)


def test_embedding_features_through_k4(dev):
    config = esm2.PRESETS["esm2_t6_8M"]
    model = esm2.init_random(config, seed=0, device=dev)
    seq, _, seqs, _ = _assay(n=40, length=60, seed=9)
    before = fa.LAUNCHES["grouped_attention_bthd"]
    got = supervised_baselines.esm_embedding_features(model, seqs, batch_size=16)
    assert fa.LAUNCHES["grouped_attention_bthd"] - before == config.num_layers * 3
    with mock.patch.object(esm2, "mha_natural", fa.plain_mha_bthd):
        want = supervised_baselines.esm_embedding_features(model, seqs, batch_size=16)
    np.testing.assert_allclose(got, want, atol=BF16_FEAT_ATOL, rtol=0)
