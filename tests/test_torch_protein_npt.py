"""ProteinNPT in the port against the JAX package on the CPU, both sides
from one JAX init through ``params_from_jax``: the forward (row and column
attention, tanh GELU, target and aux tokens), ``train`` one step at a time
with the JAX run's own batch and mask draws handed in, and ``predict``
with its seeded context. The JAX side runs inside
``jax.enable_x64(False)``."""

from unittest import mock

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from proteingym_tpu.models import protein_npt as jnpt  # noqa: E402
from proteingym_tpu_torch.models import protein_npt as tnpt  # noqa: E402
from tests.test_torch_eve_train import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

CONFIG = dict(feat_dim=21, embed_dim=16, num_layers=2, num_heads=4, context_size=12,
              train_batch=8, max_len=64)
# float32 through 2 axial layers, summation order apart (~1e-6); the
# planted fault (the exact erf GELU for tanh's) moves predictions by ~1e-3
APPLY_ATOL = 1e-5
# Adam steps on the same draws: parameters agree to rounding (~1e-7 per
# step); losses to ~1e-6
TRAIN_ATOL = 1e-5


def _data(n=40, length=10, seed=0):
    rs = np.random.RandomState(seed)
    aa = "ACDEFGHIKLMNPQRSTVWY"
    seqs = ["".join(rs.choice(list(aa), length)) for _ in range(n)]
    return (tnpt.residue_features(seqs, length), rs.randn(n).astype(np.float64),
            rs.randn(n), seqs)


def _pair(steps=3, seed=0):
    jc = jnpt.ProteinNptConfig(**CONFIG, steps=steps)
    tc = tnpt.ProteinNptConfig(**CONFIG, steps=steps)
    with jax.enable_x64(False):
        params = jnpt.init_params(jax.random.PRNGKey(seed), jc)
    model = tnpt.load_state_dict(tnpt.params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
                                 tc, device="cpu")
    return jc, tc, params, model


def jax_draws(c, n, steps, seed):
    """The batch rows and hidden targets of the JAX ``train``'s steps: per
    step ``fold_in(PRNGKey(seed), i)`` split in two, ``choice`` and
    ``bernoulli``, the first row always hidden."""
    b = min(c.train_batch, n)
    out = []
    with jax.enable_x64(False):
        for i in range(steps):
            k1, k2 = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), i))
            idx = jax.random.choice(k1, n, (b,), replace=n < b)
            hide = jax.random.bernoulli(k2, c.mask_rate, (b,)).at[0].set(True)
            out.append((np.asarray(idx).astype(np.int64), np.asarray(hide)))
    return out


@pytest.mark.parametrize("with_aux", [False, True], ids=["plain", "aux"])
def test_apply_matches_jax(with_aux):
    jc, tc, params, model = _pair()
    feats, y, aux, _ = _data(n=12)
    mask = np.arange(12) % 3 == 0
    a = aux.astype(np.float32) if with_aux else None
    with jax.enable_x64(False):
        want = np.asarray(jax.jit(lambda p, f, t, m, x: jnpt.apply(p, jc, f, t, m, aux=x))(
            params, jnp.asarray(feats), jnp.asarray(y, jnp.float32), jnp.asarray(mask),
            None if a is None else jnp.asarray(a)))
    args = (torch.from_numpy(feats), torch.tensor(y, dtype=torch.float32),
            torch.from_numpy(mask), None if a is None else torch.from_numpy(a))
    with torch.no_grad():
        got = model(*args).numpy()
        np.testing.assert_allclose(got, want, atol=APPLY_ATOL, rtol=0)
        gelu = torch.nn.functional.gelu
        with mock.patch.object(tnpt.F, "gelu", lambda x, approximate="none": gelu(x)):
            bad = model(*args).numpy()
    assert np.abs(bad - want).max() > 10 * APPLY_ATOL


def test_train_step_by_step_with_the_jax_draws():
    steps, seed = 3, 5
    feats, y, aux, _ = _data(n=30, seed=1)
    draws = jax_draws(tnpt.ProteinNptConfig(**CONFIG), len(y), steps, seed)
    jc, tc, params, model = _pair(steps=steps)
    with jax.enable_x64(False):
        jparams, jnorm = jnpt.train(params, jc, feats, y, aux=aux, seed=seed)
    model, norm = tnpt.train(model, tc, feats, y, aux=aux, draws=draws)
    # each step's loss, then every parameter after the last step
    np.testing.assert_allclose(norm["losses"], jnorm["losses"], atol=TRAIN_ATOL, rtol=0)
    assert (norm["mu"], norm["sd"]) == (jnorm["mu"], jnorm["sd"])
    want = tnpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    got = model.state_dict()
    for key in want:
        if key.endswith(".k.bias"):
            # a key bias shifts every score of a query alike, so softmax
            # ignores it: its gradient is 0 but for rounding, which Adam
            # scales to +-lr steps on either side; it moves no output
            continue
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=TRAIN_ATOL,
                                   rtol=0, err_msg=f"{key} after {steps} steps")
    # the draws of another step (the batch of step 0 again) fail the check
    _, tc, _, model = _pair(steps=steps)
    model, norm = tnpt.train(model, tc, feats, y, aux=aux, draws=[draws[0]] * steps)
    assert np.abs(norm["losses"] - jnorm["losses"]).max() > 10 * TRAIN_ATOL
    # the seeded generator's own draws: a full run is finite and learns
    _, tc, _, model = _pair(steps=60)
    _, norm = tnpt.train(model, tc, feats, y, aux=aux, seed=seed)
    assert np.isfinite(norm["losses"]).all() and len(norm["losses"]) == 60


@pytest.mark.parametrize("aux_case", ["none", "both", "context_only"])
def test_predict_matches_jax(aux_case):
    jc, tc, params, model = _pair()
    feats, y, aux, _ = _data(n=50, seed=2)
    tr, te = np.arange(50) < 35, np.arange(50) >= 35
    norm = {"mu": float(np.mean(y[tr])), "sd": float(np.std(y[tr]) + 1e-8)}
    kw = dict(train_aux=None if aux_case == "none" else aux[tr],
              test_aux=aux[te] if aux_case == "both" else None, seed=3)
    with jax.enable_x64(False), mock.patch.object(jnpt, "apply", jax.jit(
            jnpt.apply, static_argnums=1)):
        want = jnpt.predict(params, jc, norm, feats[tr], y[tr], feats[te], **kw)
    got = tnpt.predict(model, tc, norm, feats[tr], y[tr], feats[te], **kw)
    np.testing.assert_allclose(got, want, atol=APPLY_ATOL, rtol=0)


def test_cv_predict_runs_every_fold():
    feats, y, aux, _ = _data(n=40, seed=4)
    folds = np.arange(40) % 4
    c = tnpt.ProteinNptConfig(**CONFIG, steps=5)
    preds = tnpt.npt_cv_predict(feats, y, folds, c=c, aux=aux, seed=1, device="cpu")
    assert preds.shape == (40,) and np.isfinite(preds).all()
    again = tnpt.npt_cv_predict(feats, y, folds, c=c, aux=aux, seed=1, device="cpu")
    np.testing.assert_array_equal(preds, again)  # seeded: run for run equal
