"""EVE training in the port (proteingym_tpu_torch.models.eve) against the
JAX package's, in float32 at small widths.

One step is held exactly: the JAX ``make_train_step`` step draws its batch
and its noise from threefry keys, the test rebuilds those draws with
``jax.random`` (the batch from ``k_batch``, the latent noise from
``split(k_elbo)[0]``, the decoder's from ``split(split(k_elbo)[1], 4 + 2 *
layers)`` in ``variational()`` order) and hands them to the port's step at
the same params. The loss, every gradient and the parameters after 1 and 3
Adam steps must agree. A sampled run cannot agree draw for draw (threefry
against Philox), so 200 steps from the same initial params are held by
their losses and the ranks of the evol indices they give.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.models import eve as jeve
from proteingym_tpu_torch.devices import adam
from proteingym_tpu_torch.models import eve as teve

from test_torch_eve import SMALL, _both, _onehots


@pytest.fixture
def one_thread():
    """The port's side on one CPU thread: these tests run many small ops,
    which torch's intra-op pool only slows, and the test workers share the
    machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


pytestmark = pytest.mark.usefixtures("one_thread")

# the loss sums 20 x L BCE terms of magnitude ~0.1-10 per row, in float32
LOSS_RTOL = 1e-5
# gradients: float32 sums in other orders, relative to each tensor's largest
# entry (measured: 1.5e-6 at most)
GRAD_RTOL = 2e-5
# parameters after Adam steps of lr 1e-3: each step moves an entry by about
# lr times the ratio of its moments, which gradients within GRAD_RTOL carry
# to ~1e-7 (measured: 4.6e-7 at most after 3 steps); an entry whose
# gradient is within float32 noise of 0 may take the other sign (a
# difference of up to 2 lr per step), so the share of entries beyond
# PARAM_ATOL is bounded as well as the largest difference
PARAM_ATOL, PARAM_SHARE, LR = 2e-6, 1e-3, 1e-3
OPTIONS = [
    {},                                                   # convolution + temperature
    {"convolve_output": False, "include_sparsity": True, "num_tiles_sparsity": 4},
    {"include_temperature_scaler": False},
]
OPTION_IDS = ["conv_temp", "sparsity_temp", "conv"]


def _family(seed, n=60, length=9):
    """(N, L, 20) one-hots and positive weights."""
    rs = np.random.RandomState(seed)
    return _onehots(rs, n, length), (rs.rand(n) + 0.2).astype(np.float64)


def _jax_draws(model, jcfg, rng, probs, n_rows):
    """The batch indices, latent noise and decoder noise the JAX step
    draws from ``rng``."""
    k_batch, k_elbo = jax.random.split(rng)
    idx = np.asarray(jax.random.choice(k_batch, n_rows, (teve.BATCH_SIZE,), replace=True,
                                       p=jnp.asarray(probs)))
    k1, k2 = jax.random.split(k_elbo)
    z_noise = np.asarray(jax.random.normal(k1, (teve.BATCH_SIZE, jcfg.z_dim)), np.float32)
    keys = jax.random.split(k2, 4 + 2 * len(jcfg.decoder_hidden))
    decoder = [torch.from_numpy(np.array(jax.random.normal(k, mean.shape), np.float32))[None]
               for k, (mean, _) in zip(keys, model.variational())]
    return idx, torch.from_numpy(z_noise), decoder, k_elbo


def _state(params, jcfg):
    return teve.params_from_jax(jax.tree.map(np.asarray, params), jcfg)


def _assert_params_close(model, params, jcfg, what):
    want = _state(params, jcfg)
    for name, got in model.state_dict().items():
        diff = (got - want[name]).abs()
        share = float((diff > PARAM_ATOL).float().mean())
        assert share <= PARAM_SHARE and float(diff.max()) <= 6 * LR, (what, name, share,
                                                                       float(diff.max()))


@pytest.mark.parametrize("options", OPTIONS, ids=OPTION_IDS)
def test_train_step_equals_jax(options):
    model, params, jcfg = _both(11, logvar=-1.0, **options)
    model.requires_grad_(True)
    onehot, weights = _family(11)
    probs = (weights / weights.sum()).astype(np.float32)
    neff = float(weights.sum())
    init, step_fn = jeve.make_train_step(jcfg, learning_rate=LR)
    step_fn = jax.jit(step_fn)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, x, key: jeve.loss_fn(p, jcfg, x, key, neff, 1.0), has_aux=True))
    opt_state = init(params)
    optimizer = adam(model, LR)
    x_all = torch.from_numpy(onehot)
    for step in range(3):
        rng = jax.random.PRNGKey(100 + step)
        idx, z_noise, decoder, k_elbo = _jax_draws(model, jcfg, rng, probs, len(onehot))
        (want_loss, _), grads = grad_fn(params, jnp.asarray(onehot[idx]), k_elbo)
        params, opt_state, step_loss = step_fn(params, opt_state, rng, jnp.asarray(onehot),
                                               jnp.asarray(probs), neff, step)
        got = teve.train_step(model, optimizer, x_all[idx], neff, z_noise=z_noise,
                              decoder_noise=decoder)
        assert float(step_loss) == pytest.approx(float(want_loss), rel=1e-6)
        assert float(got) == pytest.approx(float(want_loss), rel=LOSS_RTOL)
        want_grads = _state(grads, jcfg)
        named = dict(model.named_parameters())
        assert set(named) == set(want_grads)
        for name, p in named.items():
            scale = float(want_grads[name].abs().max())
            np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                       atol=GRAD_RTOL * max(scale, 1e-6), rtol=0, err_msg=name)
        if step in (0, 2):
            _assert_params_close(model, params, jcfg, f"after step {step + 1}")


def test_train_draws_apart_from_init_random():
    # train's initial weights come from stream 1 of its seed: they replay
    # neither init_random(seed) nor, so, the draws of a scoring seeded alike
    config = teve.EveConfig(**RUN_CONFIG)
    onehot, weights, _ = _signal_family(16, n=40)
    first = teve.train(onehot, weights, config, steps=0, seed=5, device="cpu").state_dict()
    again = teve.train(onehot, weights, config, steps=0, seed=5, device="cpu").state_dict()
    plain = teve.init_random(config, seed=5, device="cpu").state_dict()
    assert all(torch.equal(first[k], again[k]) for k in first)
    drawn = "encoder.hidden_layers.0.weight"
    assert not torch.equal(first[drawn], plain[drawn])
    assert float(first[drawn].abs().max()) <= 1 / np.sqrt(config.seq_len * 20)  # U(-b, b)


@pytest.mark.parametrize("options", OPTIONS, ids=OPTION_IDS)
def test_loss_pieces_at_half_warm_up_equal_jax(options):
    model, params, jcfg = _both(13, logvar=-1.0, **options)
    onehot, weights = _family(13, n=7)
    neff = float(weights.sum())
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    z_noise = torch.from_numpy(np.asarray(jax.random.normal(k1, (7, jcfg.z_dim)), np.float32))
    keys = jax.random.split(k2, 4 + 2 * len(jcfg.decoder_hidden))
    decoder = [torch.from_numpy(np.array(jax.random.normal(k, mean.shape), np.float32))[None]
               for k, (mean, _) in zip(keys, model.variational())]
    want, want_aux = jeve.loss_fn(params, jcfg, jnp.asarray(onehot), key, neff, 0.5)
    with torch.no_grad():
        got, got_aux = teve.loss_fn(model, torch.from_numpy(onehot), neff, 0.5, z_noise, decoder)
    assert float(got) == pytest.approx(float(want), rel=LOSS_RTOL)
    for g, w in zip(got_aux, want_aux):
        assert float(g) == pytest.approx(float(w), rel=LOSS_RTOL)
    # the decoder KL counts: without it the loss would differ
    assert float(got_aux[2]) > 1e-3 * float(got)


def test_kld_decoder_params_with_sparsity_equals_jax():
    options = {"convolve_output": False, "include_sparsity": True, "num_tiles_sparsity": 4}
    model, params, jcfg = _both(14, **options)
    with torch.no_grad():
        got = float(teve.kld_decoder_params(model))
        model.decoder.sparsity_weight_mean.zero_()  # the prior's mean is not 0
        at_zero = float(teve.kld_decoder_params(model))
    assert got == pytest.approx(float(jeve.kld_decoder_params(params, jcfg)), rel=1e-6)
    params["decoder"]["sparsity_mean"] = jnp.zeros_like(params["decoder"]["sparsity_mean"])
    assert at_zero == pytest.approx(float(jeve.kld_decoder_params(params, jcfg)), rel=1e-6)


# ---------------------------------------------------------------------------
# A short run on both sides from the same initial params
# ---------------------------------------------------------------------------

# 200 steps of lr 3e-3 (port: Philox draws; JAX: threefry): the mean losses
# of the last 20 steps within RUN_LOSS_RTOL of each other, the evol
# indices' Spearman rank correlation at least RUN_RHO. Measured on the CPU
# from three initial params: losses 135 -> 90.8, relative differences
# 1e-3, 1.9e-4 and 8.8e-5; rank correlations 0.989, 0.996 and 0.992
RUN_STEPS, RUN_LR, RUN_LOSS_RTOL, RUN_RHO = 200, 3e-3, 1e-2, 0.9
RUN_CONFIG = dict(seq_len=12, encoder_hidden=(32, 16), decoder_hidden=(16, 32), z_dim=4,
                  convolution_depth=6)


def _signal_family(seed, n=300, length=12):
    """One-hots of a family with signal: columns 0-4 conserved (one
    letter in 95% of rows), the others drawn from a few letters each;
    weights in (0.2, 1.2)."""
    rs = np.random.RandomState(seed)
    codes = np.empty((n, length), np.int64)
    for j in range(length):
        if j < 5:
            codes[:, j] = np.where(rs.rand(n) < 0.95, j, rs.randint(0, 20, n))
        else:
            codes[:, j] = rs.choice(rs.choice(20, 4, replace=False), n)
    onehot = np.zeros((n, length, 20), np.float32)
    onehot[np.arange(n)[:, None], np.arange(length)[None], codes] = 1.0
    return onehot, rs.rand(n) + 0.2, codes[0]


def test_short_run_agrees_with_jax(monkeypatch):
    from scipy.stats import spearmanr

    jcfg, tcfg = jeve.EveConfig(**RUN_CONFIG), teve.EveConfig(**RUN_CONFIG)
    onehot, weights, wt_codes = _signal_family(15)
    # JAX: the body of jeve.train, one step per dispatch, keeping every loss
    rng, init_key = jax.random.split(jax.random.PRNGKey(0))
    params0 = jeve.init_params(init_key, jcfg)
    init, step_fn = jeve.make_train_step(jcfg, RUN_LR)
    step_fn = jax.jit(step_fn)
    params, opt_state, jax_losses = params0, init(params0), []
    probs = jnp.asarray(weights / weights.sum(), jnp.float32)
    for i in range(RUN_STEPS):
        params, opt_state, loss = step_fn(params, opt_state, jax.random.fold_in(rng, i),
                                          jnp.asarray(onehot), probs, float(weights.sum()), i)
        jax_losses.append(float(loss))
    # the port's train, from the same initial params
    start = teve.load_state_dict(_state(params0, tcfg), tcfg, device="cpu")
    monkeypatch.setattr(teve, "init_random", lambda config, **kwargs: start)
    model = teve.train(onehot, weights, tcfg, steps=RUN_STEPS, learning_rate=RUN_LR, seed=0,
                       device="cpu")
    assert model.losses.shape == (RUN_STEPS,) and not any(
        p.requires_grad for p in model.parameters())
    got, want = model.losses[-20:].mean(), np.mean(jax_losses[-20:])
    assert got < 0.8 * model.losses[:20].mean()  # it learned
    assert abs(got / want - 1) <= RUN_LOSS_RTOL, (got, want)
    wt = np.zeros((12, 20), np.float32)
    wt[np.arange(12), wt_codes] = 1.0
    mutants = []
    for pos in range(12):
        for aa in (3, 11, 17):
            if aa != wt_codes[pos]:
                m = wt.copy()
                m[pos] = 0.0
                m[pos, aa] = 1.0
                mutants.append(m)
    mutants = np.stack(mutants)
    got_idx = teve.evol_indices(model, wt, mutants, num_samples=100, seed=1)
    want_idx = jeve.evol_indices(params, jcfg, wt, mutants, num_samples=100, seed=1)
    rho = spearmanr(got_idx, want_idx).correlation
    assert rho >= RUN_RHO, rho
    # mutations of the conserved columns rank as the more deleterious
    conserved = np.arange(len(mutants)) < sum(1 for p in range(5) for a in (3, 11, 17)
                                              if a != wt_codes[p])
    assert got_idx[conserved].mean() > got_idx[~conserved].mean()
