"""The port's UniRep (proteingym_tpu_torch.models.unirep) against the JAX
package's at a small width, in float32: the published numpy weight files
read by both loaders, the logits and the harness's log-likelihoods, one
``evotune`` Adam step with the same batch handed to both sides, a short
run that raises the family's log-likelihood (as tests/test_ar_zoo.py holds
the JAX one), and the scorer's column.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import optax

from proteingym_tpu.models import ar_scoring as jar
from proteingym_tpu.models import unirep as jur
from proteingym_tpu.pipeline import scorers as jscorers
from proteingym_tpu_torch.devices import adam
from proteingym_tpu_torch.models import ar_scoring as tar
from proteingym_tpu_torch.models import unirep as tur
from proteingym_tpu_torch.pipeline import scorers as tscorers
from tests.test_torch_ar_zoo import _assay, _contexts
from tests.test_torch_eve_train import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CPU = torch.device("cpu")
SMALL = jur.UniRepConfig(embed_dim=8, hidden_dim=32)
PORT_SMALL = tur.UniRepConfig(embed_dim=8, hidden_dim=32)
# float32 on both sides; only summation orders differ: logits ~1e-6
# relative, summed log-likelihoods of ~20 tokens ~1e-5
ATOL, LL_ATOL = 1e-5, 1e-4
# one Adam step (lr 1e-4 moves an entry by ~lr): the loss relative, the
# gradients relative to each tensor's largest entry, the parameters after
# the step absolute. An entry whose gradient is within float32 noise of 0
# may step by lr the other way (2 lr apart), so PARAM_ATOL is held on all
# but a share PARAM_SHARE of the entries and PARAM_MAX on all of them
LOSS_RTOL, GRAD_RTOL, PARAM_ATOL, PARAM_SHARE, PARAM_MAX = 1e-5, 1e-4, 1e-6, 1e-2, 2.5e-4
AA = "ACDEFGHIKLMNPQRSTVWY"


def write_weights(path, c, seed=0, suffix=":0"):
    """The published files, ``<name>:0.npy``, with random float32 arrays."""
    rng = np.random.default_rng(seed)
    path.mkdir(parents=True, exist_ok=True)
    for name, shape in tur._shapes(c).items():
        scale = 0.05 if name.endswith(("_b", "biases")) else 0.3
        np.save(path / f"{name}{suffix}.npy", (rng.standard_normal(shape) * scale)
                .astype(np.float32))
    return path


@pytest.fixture
def weights(tmp_path):
    return write_weights(tmp_path / "unirep", PORT_SMALL)


def _rows(n=5, seed=1):
    rs = np.random.RandomState(seed)
    return ["".join(AA[i] for i in rs.randint(0, 20, rs.randint(4, 12))) for _ in range(n)]


def test_logits_match_jax(weights):
    params = jur.convert_tf_weights(weights, SMALL)
    model = tur.convert_tf_weights(weights, PORT_SMALL, device=CPU)
    toks = np.random.RandomState(2).randint(0, 26, (3, 14))
    want = np.asarray(jur.apply(params, SMALL, jnp.asarray(toks, jnp.int32)))
    got = model(torch.from_numpy(toks)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_loader_takes_both_file_names_and_params_from_jax(tmp_path):
    plain = write_weights(tmp_path / "plain", PORT_SMALL, seed=3, suffix="")
    model = tur.convert_tf_weights(plain, PORT_SMALL, device=CPU)
    params = jur.convert_tf_weights(plain, SMALL)
    again = tur.load_state_dict(tur.params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
                                PORT_SMALL, device=CPU)
    for (name, a), (_, b) in zip(model.named_parameters(), again.named_parameters()):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)
    with pytest.raises(FileNotFoundError, match="embed_matrix"):
        tur.convert_tf_weights(tmp_path, PORT_SMALL, device=CPU)


def test_batched_loglik_matches_jax(weights):
    params = jur.convert_tf_weights(weights, SMALL)
    model = tur.convert_tf_weights(weights, PORT_SMALL, device=CPU)
    tok = tur.UniRepTokenizer()
    seqs = _rows(7)
    rows = [tok.encode(s) for s in seqs]
    np.testing.assert_array_equal(rows[0], jur.UniRepTokenizer().encode(seqs[0]))
    want = jar.batched_ar_loglik(lambda t: jur.apply(params, SMALL, t),
                                 [r.astype(np.int32) for r in rows], tok.PAD, batch_size=3)
    got = tar.batched_ar_loglik(model, rows, tok.PAD, batch_size=3, device=CPU)
    np.testing.assert_allclose(got, want, atol=LL_ATOL, rtol=0)
    assert (got < 0).all()


def test_evotune_step_matches_jax_with_the_same_batch(weights):
    params = jur.convert_tf_weights(weights, SMALL)
    model = tur.convert_tf_weights(weights, PORT_SMALL, device=CPU).requires_grad_(True)
    tok = tur.UniRepTokenizer()
    rows = [tok.encode(s) for s in _rows(6, seed=4)]
    batch = np.zeros((6, max(map(len, rows))), np.int64)
    for i, r in enumerate(rows):
        batch[i, :len(r)] = r

    # the JAX evotune step (its step_fn) on the batch its sampler drew
    def loss_fn(p):
        logps = jax.nn.log_softmax(jur.apply(p, SMALL, jnp.asarray(batch, jnp.int32)), axis=-1)
        targets = jnp.asarray(batch[:, 1:], jnp.int32)
        ll = jnp.take_along_axis(logps[:, :-1], targets[..., None], -1)[..., 0]
        mask = (targets != jur.UNIREP_PAD).astype(jnp.float32)
        return -jnp.sum(ll * mask) / jnp.maximum(mask.sum(), 1.0)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    opt = optax.adam(1e-4)
    updates, _ = opt.update(grads, opt.init(params), params)
    stepped = optax.apply_updates(params, updates)

    got = tur.evotune_step(model, adam(model, 1e-4), torch.from_numpy(batch))
    np.testing.assert_allclose(float(got), float(loss), rtol=LOSS_RTOL)
    as_port = tur.params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    after = tur.params_from_jax(jax.tree_util.tree_map(np.asarray, stepped))
    for name, p in model.named_parameters():
        g = np.asarray(as_port[name])
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=GRAD_RTOL * float(np.abs(g).max()), err_msg=name)
        diff = np.abs(p.detach().numpy() - np.asarray(after[name]))
        assert (diff > PARAM_ATOL).mean() < PARAM_SHARE and diff.max() <= PARAM_MAX, name


def test_evotune_raises_the_family_loglik():
    # tests/test_ar_zoo.py's run: 16 rows of a family, 60 steps at lr 1e-2
    model = tur.init_params(PORT_SMALL, seed=0, device=CPU)
    rs = np.random.RandomState(5)
    fam = ["MK" + "".join(AA[i] for i in rs.randint(0, 4, 10)) for _ in range(16)]
    tok = tur.UniRepTokenizer()
    rows = [tok.encode(s) for s in fam]

    def ll():
        return tar.batched_ar_loglik(model, rows, tok.PAD, device=CPU).mean()

    before = ll()
    tur.evotune(model, fam, steps=60, learning_rate=1e-2, weights=np.linspace(1, 2, 16))
    after = ll()
    assert after > before + 1.0
    assert not any(p.requires_grad for p in model.parameters())


def test_scorer_column_matches_jax(weights):
    muts, seqs = _assay()
    extra = {"hidden_dim": 32, "embed_dim": 8}
    jctx, tctx = _contexts(muts, seqs, str(weights), extra, extra)
    want = jscorers.score_unirep(jctx)["unirep_score"].to_numpy()
    got = tscorers.SCORERS["unirep"](tctx)
    assert list(got) == ["unirep_score"]
    np.testing.assert_allclose(got["unirep_score"], want, atol=1e-5, rtol=0)
