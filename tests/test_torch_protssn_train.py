"""ProtSSN's denoising trainer on the port (``models.protssn.train_denoising``)
against the JAX ``train_denoising`` from the same weights.

The JAX function draws each step's node noise with
``jax.random.bernoulli(jax.random.fold_in(PRNGKey(seed), i), noise_prob,
(L, 1))``; the test rebuilds those draws and hands them to the port. Both
sides in float32 (the JAX side inside ``jax.enable_x64(False)``). Tolerance:
every final parameter within 1e-5 of the JAX one, relative to the largest
magnitude of its tensor (float32 sums in other orders through Adam steps).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from proteingym_tpu.models import protssn as jp
from proteingym_tpu_torch.models import protssn as tp
from proteingym_tpu_torch.ops import gnn as tgnn
from tests.test_torch_eve_train import one_thread  # noqa: F401
from tests.test_torch_protssn import noisy_helix

pytestmark = pytest.mark.usefixtures("one_thread")

ATOL = 1e-5
CONFIG = dict(node_dim=24, hidden_dim=16, num_layers=2, k_neighbors=6)
L, STEPS, SEED, NOISE = 30, 12, 5, 0.25


def _world():
    rs = np.random.RandomState(8)
    emb = rs.randn(L, CONFIG["node_dim"]).astype(np.float32)
    coords = noisy_helix(L, 3)[:, 1].astype(np.float32)
    native = rs.randint(0, 20, L)
    return emb, coords, native


def _jax_draws():
    key = jax.random.PRNGKey(SEED)
    return np.stack([np.asarray(jax.random.bernoulli(jax.random.fold_in(key, i), NOISE, (L, 1)))
                     for i in range(STEPS)])


@pytest.fixture(scope="module")
def trained():
    emb, coords, native = _world()
    with jax.enable_x64(False):
        jc = jp.ProtssnConfig(**CONFIG)
        start = jax.device_get(jp.init_params(jax.random.PRNGKey(1), jc))
        final = jax.device_get(jp.train_denoising(start, jc, emb, coords, native, steps=STEPS,
                                                  noise_prob=NOISE, seed=SEED))
        draws = _jax_draws()
    tc = tp.ProtssnConfig(**CONFIG)
    model = tgnn.egnn_load_state_dict(tgnn.egnn_params_from_jax(start), tc.egnn(), device="cpu")
    tp.train_denoising(model, tc, emb, coords, native, steps=STEPS, noise_prob=NOISE,
                       noise=draws)
    return model, tgnn.egnn_params_from_jax(final), start, draws


def test_final_parameters_match_jax(trained):
    model, want, _, _ = trained
    got = model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        w = w.numpy()
        diff = np.abs(got[name].numpy() - w).max()
        assert diff <= ATOL * max(1.0, np.abs(w).max()), (name, diff)


def test_training_moves_the_weights_and_the_loss_falls(trained):
    model, _, start, draws = trained
    moved = model.state_dict()["layers.0.edge_mlp.0.weight"].numpy()
    assert not np.allclose(moved, np.asarray(start["layers"][0]["edge_mlp"][0]["w"]).T)
    assert model.losses.shape == (STEPS,) and np.isfinite(model.losses).all()
    assert model.losses[-1] < model.losses[0]
    assert 0 < draws.mean() < 0.6  # the draws zero some nodes, not all
    assert not any(p.requires_grad for p in model.parameters())


def test_seeded_draws_without_noise_given():
    emb, coords, native = _world()
    tc = tp.ProtssnConfig(**CONFIG)
    runs = []
    for seed in (0, 0, 1):
        model = tp.init_params(tc, seed=2, device="cpu")
        tp.train_denoising(model, tc, emb, coords, native, steps=3, seed=seed)
        runs.append(model.losses)
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])


def test_no_noise_equals_plain_adam_on_the_clean_embeddings():
    # with every draw False the objective is the clean NLL: one step equals a
    # hand-written Adam step on it
    emb, coords, native = _world()
    tc = tp.ProtssnConfig(**CONFIG)
    model = tp.init_params(tc, seed=2, device="cpu")
    ref = tp.init_params(tc, seed=2, device="cpu").requires_grad_(True)
    tp.train_denoising(model, tc, emb, coords, native, steps=1,
                       noise=np.zeros((1, L, 1), bool))
    opt = torch.optim.Adam(ref.parameters(), lr=1e-3)
    c = torch.from_numpy(coords)
    h, _ = ref(torch.from_numpy(emb), c, tgnn.knn_graph(c, tc.k_neighbors))
    loss = -torch.log_softmax(ref.readout(h), -1)[torch.arange(L), torch.from_numpy(native)].mean()
    loss.backward()
    opt.step()
    for (name, a), b in zip(model.state_dict().items(), ref.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), atol=1e-7, rtol=0, err_msg=name)
    assert dataclasses.asdict(tc)["k_neighbors"] == CONFIG["k_neighbors"]


def test_losses_at_the_default_widths_match_jax(capsys):
    # ProtssnConfig's defaults (node 1,280, hidden 512, 6 layers, k 20) on 32
    # nodes: the JAX package's own losses from its He-normal init run to
    # ~1e7-1e9 (the residual features grow through the six layers), and the
    # port's follow them. The port's first two losses against the JAX loss
    # of the same draw at the JAX parameters before and after one step: the
    # first within 1e-5 relative, the second within 1e-2 (float32 sums in
    # other orders through an Adam step at these losses; 8.2e-4 read on the
    # CPU)
    import jax.numpy as jnp

    from proteingym_tpu.ops import gnn as jgnn

    n = 32
    rs = np.random.RandomState(8)
    jc, tc = jp.ProtssnConfig(), tp.ProtssnConfig()
    emb = rs.randn(n, jc.node_dim).astype(np.float32)
    coords = noisy_helix(n, 3)[:, 1].astype(np.float32)
    native = rs.randint(0, 20, n)
    cfg = jc.egnn()
    with jax.enable_x64(False):
        start = jax.device_get(jp.init_params(jax.random.PRNGKey(1), jc))
        key = jax.random.PRNGKey(SEED)
        draws = np.stack([np.asarray(jax.random.bernoulli(jax.random.fold_in(key, i), NOISE,
                                                          (n, 1))) for i in range(2)])
        neighbors = jgnn.knn_graph(jnp.asarray(coords), cfg.k_neighbors)

        def nll(p, noise):
            h, _ = jgnn.egnn_apply(p, cfg, jnp.where(noise, 0.0, jnp.asarray(emb)),
                                   jnp.asarray(coords), neighbors)
            logp = jax.nn.log_softmax(jgnn.egnn_readout(p, cfg, h), -1)
            return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(native)[:, None], -1)[:, 0])

        loss = jax.jit(nll)
        one = jp.train_denoising(start, jc, emb, coords, native, steps=1, noise_prob=NOISE,
                                 seed=SEED)
        want = [float(loss(start, draws[0])), float(loss(one, draws[1]))]
    model = tgnn.egnn_load_state_dict(tgnn.egnn_params_from_jax(start), tc.egnn(), device="cpu")
    tp.train_denoising(model, tc, emb, coords, native, steps=2, noise=draws)
    got = model.losses.tolist()
    with capsys.disabled():
        print(f"\n  ProtSSN defaults, {n} nodes: JAX losses {want}, port {got}")
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    assert rel[0] <= 1e-5 and rel[1] <= 1e-2, rel
