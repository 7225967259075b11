"""ESM-IF1, ProteinMPNN, SaProt and MULAN on the card: K1's float32 kernel at
ESM-IF1's two shapes (the decoder's causal self attention with the PAD
mask, the encoder's with its padding mask) against its plain version,
ESM-IF1's log-probs with the kernel against the plain attention per token
(a causal mask left off must fail that check), its scores, the multichain
path and ProteinMPNN's scores on the card against the CPU, SaProt's
trunk through K4, and a toy MULAN (its float32 trunk on K4, its adapter on
K1 in "mask" mode, both at head dim 24) per token against the plain
attention, with the adapter's last key tile skipped shown to fail that
check. Structure slice C: K1 in bf16 at AIDO's two shapes (8 heads of 64,
every key live, the default scale through the pre-pass) against its plain
version; AIDO's per-token log-probs through K1 against the plain attention
(the last key tile skipped must fail that check); ProtSSN's stack, S3F with
its surface stream and a float32 AIDO's sliding table on the card against
the CPU.

Every test needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The file imports neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_structure_cuda.py
"""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

from proteingym_tpu_torch.data.structures import synthetic_helix_backbone
from proteingym_tpu_torch.models import esm2, gvp_transformer as tg, mulan, protein_mpnn as tm
from proteingym_tpu_torch.models import progen3, protssn, s3f, saprot
from proteingym_tpu_torch.models import structure_plms as sp
from proteingym_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

# float32 without TF32 on both devices: summation order (index_add_'s
# among it) through a few layers
F32_ATOL = 1e-4
# bf16 SaProt trunk, kernel vs plain attention, scores through 2 layers
BF16_SCORE_ATOL = 5e-2
AA = "ACDEFGHIKLMNPQRSTVWY"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _backbone(n, seed):
    coords = synthetic_helix_backbone(n, seed=seed).astype(np.float32)
    coords[:, 1] += 0.05 * np.random.RandomState(seed).randn(n, 3).astype(np.float32)
    return coords


def _seqs(n, length, seed):
    rng = np.random.RandomState(seed)
    return ["".join(rng.choice(list(AA), length)) for _ in range(n)]


# (B, H, T, D, causal): ESM-IF1's decoder rows (250 residues + <cath>, the
# last token dropped) and its encoder (L + 2 = 252)
K1_SHAPES = {"decoder": (32, 8, 250, 64, True), "encoder": (1, 8, 252, 64, False)}


@pytest.mark.parametrize("shape", sorted(K1_SHAPES))
def test_k1_at_esm_if1_shapes_matches_plain(shape, dev):
    b, h, t, d, causal = K1_SHAPES[shape]
    gen = torch.Generator(device=dev).manual_seed(t)
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device=dev).transpose(1, 2)
               for _ in range(3))
    lengths = torch.randint(t - 20, t + 1, (b,), generator=gen, device=dev)
    mask = torch.arange(t, device=dev)[None] < lengths[:, None]
    mask[:, 0] = True
    got = fa.grouped_mha(q, k, v, key_mask=mask, causal=causal, sm_scale=1.0)
    want = fa.plain_mha(q, k, v, key_mask=mask, causal=causal, sm_scale=1.0)
    torch.testing.assert_close(got, want, atol=F32_ATOL, rtol=F32_ATOL)


# ESM-IF1 at head dim 64 (the published heads), two layers each side
MID = tg.GVPTransformerConfig(name="mid", encoder_embed_dim=128, decoder_embed_dim=128,
                              encoder_layers=2, decoder_layers=2, encoder_attention_heads=2,
                              decoder_attention_heads=2, encoder_ffn_embed_dim=256,
                              decoder_ffn_embed_dim=256, gvp_node_hidden_dim_scalar=64,
                              gvp_node_hidden_dim_vector=16, gvp_num_encoder_layers=2)


def _tokens(seqs):
    rows = [tg.tokenize(s) for s in seqs]
    tok = np.full((len(rows), max(map(len, rows))), tg.PAD_IDX, np.int64)
    for i, r in enumerate(rows):
        tok[i, :len(r)] = r
    return torch.as_tensor(tok)


def test_esm_if1_logprobs_through_k1_per_token(dev):
    """One launch of the float32 K1 per encoder layer and per decoder self
    attention; the per-token log-probs equal the plain attention's, and the
    same check fails with the decoder's causal mask left off."""
    model = tg.init_random(MID, seed=1, device=dev)
    coords = _backbone(60, seed=1)
    tok = _tokens(_seqs(6, 60, 1) + _seqs(2, 54, 2)).to(dev)

    def token_logp(attention=None):
        with torch.no_grad(), (mock.patch.object(tg, "mha", attention) if attention
                               else contextlib.nullcontext()):
            enc, pad = tg.encode_structure(model, coords)
            logp = torch.log_softmax(model.decoder(tok[:, :-1], enc, pad), -1)
        return logp.gather(-1, tok[:, 1:, None])[..., 0]

    before = dict(fa.LAUNCHES)
    got = token_logp()
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in fa.LAUNCHES.items() if v != before[k]}
    assert launched == {"grouped_attention": MID.encoder_layers + MID.decoder_layers}
    want = token_logp(fa.plain_mha)
    live = tok[:, 1:] != tg.PAD_IDX
    torch.testing.assert_close(got[live], want[live], atol=F32_ATOL, rtol=0)
    leaked = token_logp(lambda q, k, v, causal=False, **kw: fa.plain_mha(q, k, v, **kw))
    assert float((leaked - want)[live].abs().max()) > 100 * F32_ATOL


def test_esm_if1_scores_on_the_card_equal_cpu(dev):
    cpu = tg.init_random(MID, seed=2, device="cpu")
    card = tg.load_state_dict(cpu.state_dict(), MID, device=dev)
    coords = _backbone(70, seed=3)
    seqs = _seqs(9, 70, 3) + _seqs(1, 72, 4)  # an indel row as long as the encoder
    want = tg.score_sequences(cpu, coords, seqs, batch_size=4)
    got = tg.score_sequences(card, coords, seqs, batch_size=4)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    chains = {"A": coords[:40], "B": _backbone(30, seed=5)[:, :3] + 15.0}
    short = [s[:40] for s in seqs[:4]]
    want = tg.score_sequences_in_complex(cpu, chains, "A", short, batch_size=2)
    got = tg.score_sequences_in_complex(card, chains, "A", short, batch_size=2)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    assert np.isfinite(want).all()


def test_protein_mpnn_scores_on_the_card_equal_cpu(dev):
    config = tm.PRESETS["v_48_020"]
    cpu = tm.init_random(config, seed=3, device="cpu")
    card = tm.load_state_dict(cpu.state_dict(), config, device=dev)
    coords = synthetic_helix_backbone(80, seed=4).astype(np.float32)
    seqs = _seqs(5, 80, 5)
    want = tm.score_sequences(cpu, coords, seqs, n_orders=3)
    got = tm.score_sequences(card, coords, seqs, n_orders=3)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(tm.score_sequences(card, coords, seqs, n_orders=3, max_pairs=4),
                               got, atol=F32_ATOL, rtol=0)


def test_saprot_trunk_goes_through_k4(dev):
    config = esm2.EsmConfig("saprot_mid", 2, 256, 4, alphabet_size=saprot.VOCAB.size)
    model = esm2.init_random(config, seed=4, device=dev)
    coords = synthetic_helix_backbone(60, seed=6) + 0.4 * np.random.RandomState(6).randn(60, 4, 3)
    seq = _seqs(1, 60, 6)[0]
    muts = [f"{seq[p]}{p + 1}{a}" for p in range(0, 60, 5) for a in "AW" if a != seq[p]]
    before = dict(fa.LAUNCHES)
    got = saprot.score_assay_saprot(model, seq, coords, muts, batch_size=8)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in fa.LAUNCHES.items() if v != before[k]}
    forwards = -(-len(muts) // 8)
    assert launched == {"grouped_attention_bthd": 2 * forwards, "rope_qk": 2 * forwards}
    with mock.patch.object(esm2, "mha_natural", fa.plain_mha_bthd):
        want = saprot.score_assay_saprot(model, seq, coords, muts, batch_size=8)
    np.testing.assert_allclose(got, want, atol=BF16_SCORE_ATOL, rtol=0)


def test_mulan_logprobs_through_k1_and_k4_per_token(dev):
    import dataclasses

    # 2 layers of 8 heads of 24 (the published model: 20 of 24), float32
    trunk = esm2.EsmConfig("mulan_toy", 2, 192, 8, dtype=torch.float32)
    config = dataclasses.replace(mulan.PRESETS["mulan_small"], name="mulan_toy", esm=trunk)
    model = mulan.init_random(config, seed=7, device=dev)
    seq = _seqs(1, 250, 7)[0]
    angles = mulan.backbone_angle_features(_backbone(250, 7))
    toks = np.tile(esm2.ALPHABET.tokenize(seq)[None], (8, 1)).astype(np.int64)
    feats = np.tile(mulan.build_struct_features(angles)[None], (8, 1, 1))
    for i in range(8):  # each row a masked position, and a pad tail on half of them
        toks[i, 1 + 30 * i] = esm2.ALPHABET.mask_idx
        feats[i, 1 + 30 * i] = mulan.MASKED_ANGLE
    toks[4:, -20:] = esm2.ALPHABET.padding_idx
    toks_d, feats_d = torch.as_tensor(toks, device=dev), torch.as_tensor(feats, device=dev)

    def logp(patches=()):
        with torch.no_grad(), contextlib.ExitStack() as stack:
            for patch in patches:
                stack.enter_context(patch)
            return torch.log_softmax(model(toks_d, feats_d), -1)

    before = dict(fa.LAUNCHES)
    got = logp()
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in fa.LAUNCHES.items() if v != before[k]}
    assert launched == {"grouped_attention": 1, "grouped_attention_bthd": 2}
    plain = [mock.patch.object(esm2, "mha_natural", fa.plain_mha_bthd),
             mock.patch.object(mulan, "mha", fa.plain_mha)]
    want = logp(plain)
    live = torch.as_tensor(toks != esm2.ALPHABET.padding_idx, device=dev)
    err = float((got - want).abs()[live].max())
    assert err < F32_ATOL, err

    def last_tile_skipped(q, k, v, key_mask=None, **kw):  # the adapter's keys past 192 dropped
        mask = key_mask.clone()
        mask[:, 192:] = False
        return fa.plain_mha(q, k, v, key_mask=mask, **kw)

    fault = logp([plain[0], mock.patch.object(mulan, "mha", last_tile_skipped)])
    assert float((fault - want).abs()[live].max()) > 10 * F32_ATOL  # 3.5e-3 on the CPU


# (B, H, T, D) of AIDO's attention: [CLS] + 250 + [EOS], and a 768-residue window
K1_AIDO = {"T252": (32, 8, 252, 64), "T770": (32, 8, 770, 64)}
# bf16 kernel vs the float32 plain version of the same bf16 inputs
BF16_ATOL = 2e-2
# AIDO's per-token log-probs (bf16, 2 layers at the published width), K1
# against the plain attention with the kernel run's expert routing
# replayed: the outputs' bf16 rounding only, 7.1e-3 on an H100 at 700 W,
# and the last key tile skipped 0.275 (without the replay a router near-tie
# flipped by one bf16 ulp moves a token by 0.275 too)
AIDO_LOGP_ATOL = 2e-2


@pytest.mark.parametrize("shape", sorted(K1_AIDO))
def test_k1_at_aido_shapes_matches_plain(shape, dev):
    b, h, t, d = K1_AIDO[shape]
    gen = torch.Generator(device=dev).manual_seed(t)
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device=dev).to(torch.bfloat16)
               .transpose(1, 2) for _ in range(3))
    mask = torch.ones(b, t, dtype=torch.bool, device=dev)
    before = dict(fa.LAUNCHES)
    got = fa.mha(q, k, v, key_mask=mask)
    torch.cuda.synchronize()
    launched = {k_: v_ - before[k_] for k_, v_ in fa.LAUNCHES.items() if v_ != before[k_]}
    assert launched == {"grouped_attention": 1, "rope_qk": 1}
    want = fa.plain_mha(q.float(), k.float(), v.float(), key_mask=mask)
    torch.testing.assert_close(got.float(), want, atol=BF16_ATOL, rtol=BF16_ATOL)


def _aido_rows(n, t, seed):
    rng = np.random.RandomState(seed)
    rows = np.asarray([[esm2.ALPHABET.cls_idx] + [esm2.ALPHABET.get_idx(a) for a in
                                                  rng.choice(list(AA), t - 2)]
                       + [esm2.ALPHABET.eos_idx] for _ in range(n)], np.int64)
    rows[np.arange(n), 1 + 29 * np.arange(n)] = esm2.ALPHABET.mask_idx
    return rows


def test_aido_logprobs_through_k1_per_token(dev):
    import dataclasses

    model = sp.aido_init(dataclasses.replace(sp.AidoConfig(), num_layers=2), seed=6, device=dev)
    rows = torch.as_tensor(_aido_rows(8, 252, 6), device=dev)
    chosen, route = [], progen3.router_weights

    def logp(attention=None):
        # the kernel run records its expert routing, the others replay it
        replay = None if attention is None else iter(list(chosen))

        def routed(x32, router, num_experts, top_k):
            if replay is not None:
                return next(replay)
            chosen.append(route(x32, router, num_experts, top_k))
            return chosen[-1]

        with torch.no_grad(), contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(progen3, "router_weights", routed))
            if attention is not None:
                stack.enter_context(mock.patch.object(sp, "mha", attention))
            out = torch.log_softmax(model(rows), -1)
        return out.gather(-1, rows[..., None])[..., 0]

    before = dict(fa.LAUNCHES)
    got = logp()
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in fa.LAUNCHES.items() if v != before[k]}
    assert launched == {"grouped_attention": 2, "rope_qk": 2}
    want = logp(fa.plain_mha)
    err = float((got - want).abs().max())

    def last_tile_skipped(q, k, v, key_mask=None, **kw):  # keys past 192 dropped
        mask = key_mask.clone()
        mask[:, 192:] = False
        return fa.plain_mha(q, k, v, key_mask=mask, **kw)

    fault = float((logp(last_tile_skipped) - want).abs().max())
    print(f"AIDO per token, 2 layers, routing replayed: K1 vs plain {err:.4g}, "
          f"the last key tile skipped {fault:.4g} (limit {AIDO_LOGP_ATOL:g})")
    assert err < AIDO_LOGP_ATOL, err
    assert fault > AIDO_LOGP_ATOL, fault


def test_protssn_on_the_card_equals_cpu(dev):
    config = protssn.ProtssnEgnnConfig(name="mid", input_dim=160, m_dim=64, n_layers=2)
    cpu = protssn.init_random(config, seed=3, device="cpu")
    card = protssn.load_state_dict(cpu.state_dict(), config, device=dev)
    src, dst, edge_attr, pos = protssn.build_calpha_graph(_backbone(90, 4)[:, :3], 20)
    npos, nea = protssn.apply_norm_stats(pos, edge_attr, protssn.identity_norm_stats())
    emb = np.random.RandomState(5).randn(90, 160).astype(np.float32)
    want = protssn.egnn_log_probs(cpu, emb, npos, src, dst, nea)
    got = protssn.egnn_log_probs(card, emb, npos, src, dst, nea)
    torch.testing.assert_close(got.cpu(), want, atol=F32_ATOL, rtol=0)


def test_s3f_with_its_surface_on_the_card_equals_cpu(dev):
    import dataclasses

    config = dataclasses.replace(s3f.S3F_PRESETS["s3f"], node_in=160, num_layers=2)
    cpu = s3f.init_random(config, seed=4, device="cpu")
    card = s3f.load_state_dict(cpu.state_dict(), config, device=dev)
    pos = _backbone(90, 5)[:, 1]
    src, dst = s3f.radius_graph(pos, config.radius)
    rs = np.random.RandomState(6)
    surface = s3f.build_surface_inputs(
        (pos[rs.randint(0, 90, 400)] + 2 * rs.randn(400, 3)).astype(np.float32),
        rs.randn(400, config.surf_in_s).astype(np.float32), pos, config)
    emb = rs.randn(90, 160).astype(np.float32)
    want = s3f.gvpgnn_node_logits(cpu, emb, pos, src, dst, surface)
    got = s3f.gvpgnn_node_logits(card, emb, pos, src, dst, surface)
    torch.testing.assert_close(got.cpu(), want, atol=F32_ATOL, rtol=0)


def test_aido_table_on_the_card_equals_cpu(dev):
    # float32 at head dim 64 (the float32 K1), one published window over 40 residues
    config = sp.AidoConfig(name="aido_mid", num_layers=2, embed_dim=128, num_heads=2, ffn_dim=64,
                           num_experts=4, dtype=torch.float32)
    cpu = sp.aido_init(config, seed=5, device="cpu")
    card = sp.aido_load_state_dict(cpu.state_dict(), config, device=dev)
    seq = _seqs(1, 40, 8)[0]
    want = sp.aido_logits_table(cpu, seq, chunk=8)
    before = dict(fa.LAUNCHES)
    got = sp.aido_logits_table(card, seq, chunk=8)
    # one window: 40 masked grids in 5 forwards of 2 layers
    assert fa.LAUNCHES["grouped_attention"] - before["grouped_attention"] == 2 * 5
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
