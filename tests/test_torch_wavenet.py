"""The port's WaveNet (proteingym_tpu_torch.models.wavenet) against the JAX
package's, in float32 at small widths: the forward's logits and its
causality, ``score_sequences``, the training rows and Adam steps at the
same params and batch indices (the JAX trainer's ``jax.random.categorical``
draws, rebuilt in the test), and the ``wavenet`` scorer through both CLIs.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.models import wavenet as jwn
from proteingym_tpu_torch.devices import adam
from proteingym_tpu_torch.models import wavenet as twn

from test_torch_eve_train import one_thread  # noqa: F401
from test_torch_indel import run_both_clis, write_indel_world

pytestmark = pytest.mark.usefixtures("one_thread")

# float32 on both sides, sums in other orders: logits of magnitude ~1-5
ATOL = 1e-5
# summed log-likelihoods of ~20-60 tokens of magnitude ~3
SCORE_ATOL = 1e-4
# the loss, relative; the parameters after Adam steps of lr 1e-3 (each
# entry moves by about lr per step, so float32 noise in a gradient shows
# as ~lr * 1e-4; an entry whose gradient is within noise of 0 may take the
# other sign, so the share beyond PARAM_ATOL is bounded as well)
LOSS_RTOL, PARAM_ATOL, PARAM_SHARE = 1e-5, 2e-6, 1e-3
SMALL = dict(embed_dim=16, hidden_dim=12, num_layers=5, max_dilation=4, batch=8)
AA = "ACDEFGHIKLMNPQRSTVWY"


def _both(seed, **overrides):
    jcfg = jwn.WavenetConfig(**{**SMALL, **overrides})
    tcfg = twn.WavenetConfig(**{**SMALL, **overrides})
    params = jax.tree.map(np.asarray, jwn.init_params(jax.random.PRNGKey(seed), jcfg))
    rs = np.random.RandomState(seed)  # biases and layer norms off their constants
    params = jax.tree.map(lambda x: x + rs.randn(*x.shape).astype(np.float32) * 0.2, params)
    model = twn.load_state_dict(twn.params_from_jax(params, tcfg), tcfg, device="cpu")
    return model, jax.tree.map(jnp.asarray, params), jcfg


def _sequences(rs, n, length=20):
    return ["".join(AA[i] for i in rs.randint(0, 20, length + rs.randint(-4, 5)))
            for _ in range(n)]


def test_forward_equals_jax_and_is_causal():
    model, params, jcfg = _both(1)
    tokens = np.random.RandomState(1).randint(0, 22, (3, 40))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long()).numpy()
    want = np.asarray(jwn.apply(params, jcfg, jnp.asarray(tokens, jnp.int32)))
    assert got.shape == (3, 40, 22)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # a token at position 25 changes the logits at 25 and the 10 after it
    # (the receptive field: 1 + the dilations 1, 2, 4, 1, 2) and no others
    changed = tokens.copy()
    changed[:, 25] = (changed[:, 25] + 1) % 22
    with torch.no_grad():
        again = model(torch.from_numpy(changed).long()).numpy()
    moved = np.abs(again - got).max(axis=(0, 2)) > 0
    np.testing.assert_array_equal(moved, (np.arange(40) >= 25) & (np.arange(40) <= 35))


def test_score_sequences_equal_jax():
    model, params, jcfg = _both(2)
    rs = np.random.RandomState(2)
    seqs = _sequences(rs, 9) + ["acdXZ-QW", "M"]  # encoded as given: lower case and '-' are X
    got = twn.score_sequences(model, seqs, batch=4)
    want = jwn.score_sequences(params, jcfg, seqs, batch=4)
    assert got.dtype == np.float64 and got.shape == (11,)
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)
    np.testing.assert_array_equal(twn.encode("acdXZ-QW"), jwn.encode("acdXZ-QW"))
    assert np.ptp(got[:9]) > 1.0


def _rows(seed):
    rs = np.random.RandomState(seed)
    seqs = [s[:5] + "-." + s[5:].lower() for s in _sequences(rs, 30)] + ["A-", "--", "AC"]
    return seqs, rs.rand(len(seqs)) + 0.1


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_equal_jax(steps):
    model, params, jcfg = _both(3)
    seqs, weights = _rows(3)
    jcfg = jwn.WavenetConfig(**{**SMALL, "steps": steps})
    want_params, want_losses = jwn.train(params, jcfg, seqs, weights=weights, seed=4)
    tokens, mask, probs = twn.training_rows(seqs, weights)
    assert len(tokens) == len(seqs) - 2  # "A-" and "--" have no target to learn
    logp = jnp.asarray(np.log(probs + 1e-12))
    optimizer = adam(model.requires_grad_(True), jcfg.learning_rate)
    for i in range(steps):
        idx = np.asarray(jax.random.categorical(
            jax.random.fold_in(jax.random.PRNGKey(4), i), logp, shape=(SMALL["batch"],)))
        got = twn.train_step(model, optimizer, torch.from_numpy(tokens[idx]),
                             torch.from_numpy(mask[idx]))
        assert float(got) == pytest.approx(float(want_losses[i]), rel=LOSS_RTOL)
    want = twn.params_from_jax(jax.tree.map(np.asarray, want_params), twn.WavenetConfig(**SMALL))
    for name, value in model.state_dict().items():
        diff = (value - want[name]).abs()
        assert float((diff > PARAM_ATOL).float().mean()) <= PARAM_SHARE, name
        assert float(diff.max()) <= 2 * steps * jcfg.learning_rate, name
    assert any(float((value - start).abs().max()) > 1e-4 for value, start in zip(
        model.state_dict().values(), _both(3)[0].state_dict().values()))  # it moved


def test_train_learns_the_family():
    config = twn.WavenetConfig(**{**SMALL, "steps": 60})
    model = twn.init_random(config, seed=0, device="cpu")
    seqs = ["MKV" + "".join(AA[(3 * j + k) % 20] for j in range(15)) for k in range(4)] * 8
    model, losses = twn.train(model, config, seqs, seed=1)
    assert losses.shape == (60,) and losses[-5:].mean() < 0.5 * losses[:5].mean()
    assert not any(p.requires_grad for p in model.parameters())
    scores = twn.score_sequences(model, [seqs[0], seqs[0][::-1]])
    assert scores[0] > scores[1] + 5  # a family member beats its reverse


def test_init_random_follows_the_jax_distribution():
    config = twn.WavenetConfig(**SMALL)
    sd = twn.init_random(config, seed=1, device="cpu").state_dict()
    jsd = twn.params_from_jax(jax.tree.map(np.asarray, jwn.init_params(
        jax.random.PRNGKey(0), jwn.WavenetConfig(**SMALL))), config)
    assert set(sd) == set(jsd)
    for key in sd:
        assert sd[key].shape == jsd[key].shape, key
        if key.endswith("bias") or "ln" in key:
            assert torch.equal(sd[key], jsd[key]), key  # constants
        else:
            assert float(sd[key].std()) == pytest.approx(float(jsd[key].std()), rel=0.5), key
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            twn.init_random(config, seed=1)  # the default is the card


def test_wavenet_cli_writes_the_jax_cli_column(tmp_path):
    from proteingym_tpu_torch.msa.parser import load_msa

    target, seqs = write_indel_world(tmp_path)
    port, want = run_both_clis(tmp_path, "wavenet", ["steps=20", "num_layers=2", "seed=3"])
    assert port[0] == want[0] and port[0][-1] == "Wavenet_score"
    assert [r[:-1] for r in port] == [r[:-1] for r in want]
    got = np.asarray([float(r[-1]) for r in port[1:]])
    assert np.isfinite(got).all() and len(got) == len(seqs)
    assert np.isfinite(np.asarray([float(r[-1]) for r in want[1:]])).all()
    # the two sides train from other initial draws (held step by step
    # above); the port's column is its own model's: init_random(seed=0),
    # trained on the alignment's rows by weight with the --extra seed,
    # scored in the CLI's batches of 4
    config = twn.WavenetConfig(steps=20, num_layers=2)
    msa = load_msa(tmp_path / "msa" / "FAM.a2m")
    model, _ = twn.train(twn.init_random(config, seed=0, device="cpu"), config, msa.sequences(),
                         weights=np.load(tmp_path / "w" / "FAM.npy"), seed=3)
    np.testing.assert_allclose(got, twn.score_sequences(model, seqs, batch=4), atol=1e-6, rtol=0)
