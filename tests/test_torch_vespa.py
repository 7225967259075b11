"""VESPA's heads and VespaG in the port against the JAX package on the CPU:
the ConsCNN from one ``prott5cons``-layout state dict, the SAV blend and
its ingestion, VespaG's three architectures from one published-layout
state dict, and the GEMME-teacher distillation step by step. The JAX side
runs inside ``jax.enable_x64(False)``."""

from unittest import mock

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from proteingym_tpu.models import vespa_heads as jvh  # noqa: E402
from proteingym_tpu.models import vespag as jvg  # noqa: E402
from proteingym_tpu_torch.models import vespa_heads as tvh  # noqa: E402
from proteingym_tpu_torch.models import vespag as tvg  # noqa: E402
from tests.test_torch_eve_train import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

AA = "ACDEFGHIKLMNPQRSTVWY"
# float32 convolutions and products on both sides, summation order apart
# (~1e-7 relative); a planted fault (the ConsCNN's ReLU left out, a wrong
# LeakyReLU slope) moves them by O(0.01-1)
HEAD_ATOL = 1e-5
# Adam on the same gradients: the updates differ by rounding (~1e-7) only
TRAIN_ATOL = 1e-5


def _seq(n, seed):
    return "".join(np.random.RandomState(seed).choice(list(AA), n))


def _mutants(seq, seed, n=30):
    rs = np.random.RandomState(seed)
    out = ["WT", f"{seq[3]}4{seq[3]}"]
    for _ in range(n):
        k = rs.randint(1, 4)
        pos = sorted(rs.choice(len(seq), k, replace=False))
        out.append(":".join(f"{seq[p]}{p + 1}{rs.choice(list(AA))}" for p in pos))
    return out


def test_conscnn_matches_jax():
    d, length = 64, 37
    rs = np.random.RandomState(0)
    sd = {"0.weight": rs.randn(32, d, 7, 1).astype(np.float32) * 0.05,
          "0.bias": rs.randn(32).astype(np.float32) * 0.1,
          "3.weight": rs.randn(9, 32, 7, 1).astype(np.float32) * 0.1,
          "3.bias": rs.randn(9).astype(np.float32) * 0.1}
    emb = rs.randn(length, d).astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jvh.conservation_probs(jvh.convert_conscnn_state_dict(sd),
                                                 jnp.asarray(emb)))
    model = tvh.load_conscnn_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                        device="cpu")
    got = tvh.conservation_probs(model, torch.from_numpy(emb))
    np.testing.assert_allclose(got, want, atol=HEAD_ATOL, rtol=0)
    # the JAX init through params_from_jax, and the ReLU left out as a fault
    with jax.enable_x64(False):
        params = jvh.init_conscnn(jax.random.PRNGKey(1), d_model=d)
        want = np.asarray(jvh.conservation_probs(params, jnp.asarray(emb)))
    model = tvh.load_conscnn_state_dict(tvh.conscnn_params_from_jax(params), device="cpu")
    np.testing.assert_allclose(tvh.conservation_probs(model, torch.from_numpy(emb)), want,
                               atol=HEAD_ATOL, rtol=0)
    with mock.patch.object(torch, "relu", lambda x: x):
        bad = tvh.conservation_probs(model, torch.from_numpy(emb))
    assert np.abs(bad - want).max() > 10 * HEAD_ATOL


@pytest.mark.parametrize("light", [False, True], ids=["full", "light"])
def test_blend_and_ingestion_equal_jax(light):
    seq = _seq(40, 2)
    rs = np.random.RandomState(3)
    cons = rs.dirichlet(np.ones(9), len(seq)).astype(np.float32)
    logodds = None if light else np.log(rs.dirichlet(np.ones(20), len(seq))).astype(np.float32)
    mutants = _mutants(seq, 4)
    want = jvh.vespa_table(seq, cons, logodds)
    got = tvh.vespa_table(seq, cons, logodds)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tvh.score_mutants(got, seq, mutants),
                                  jvh.score_mutants(want, seq, mutants))
    blend = {"w": rs.randn(11).astype(np.float32), "b": 0.3}
    np.testing.assert_array_equal(tvh.vespa_table(seq, cons, logodds, blend),
                                  jvh.vespa_table(seq, cons, logodds, blend))


def _fnn_state(rs, d, hidden=(16,)):
    dims = (d, *hidden, 20)
    sd = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        sd[f"net.{2 * i}.weight"] = rs.randn(b, a).astype(np.float32) / np.sqrt(a)
        sd[f"net.{2 * i}.bias"] = rs.randn(b).astype(np.float32) * 0.1
    return sd


def _stack(rs, prefix, dims):
    sd = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        sd[f"{prefix}.{i}.weight"] = rs.randn(b, a).astype(np.float32) / np.sqrt(a)
        sd[f"{prefix}.{i}.bias"] = rs.randn(b).astype(np.float32) * 0.1
    return sd


def vespag_state(arch, d, seed=0):
    """A seeded state dict in the published VespaG layout of ``arch``."""
    rs = np.random.RandomState(seed)
    if arch == "fnn":
        return _fnn_state(rs, d)
    conv = lambda p: {f"{p}.weight": rs.randn(8, d, 7).astype(np.float32) / np.sqrt(7 * d),  # noqa: E731
                      f"{p}.bias": rs.randn(8).astype(np.float32) * 0.1}
    if arch == "cnn":
        return {**conv("conv.0"), **_stack(rs, "fnn", (8, 12, 20))}
    return {**conv("conv.conv.0"), **_stack(rs, "conv.fnn", (8, 10)),
            **_stack(rs, "fnn", (d, 6)), **_stack(rs, "combined", (16, 20))}


@pytest.mark.parametrize("arch", ["fnn", "cnn", "combined"])
def test_vespag_architectures_match_jax(arch):
    d, seq = 24, _seq(33, 5)
    sd = vespag_state(arch, d)
    emb = np.random.RandomState(6).randn(len(seq), d).astype(np.float32)
    with jax.enable_x64(False):
        params = jvg.convert_torch_state_dict(sd)
        want = np.asarray(jvg.apply(params, jnp.asarray(emb)))
    head = tvg.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, device="cpu")
    assert head["arch"] == params["arch"] == arch
    got = tvg.landscape(head, torch.from_numpy(emb))
    np.testing.assert_allclose(got, want, atol=HEAD_ATOL, rtol=0)
    mutants = [m for m in _mutants(seq, 7)]
    for normalize in (True, False):
        np.testing.assert_allclose(
            tvg.score_mutants_reference(got, seq, mutants, normalize=normalize),
            jvg.score_mutants_reference(want, seq, mutants, normalize=normalize),
            atol=1e-4, rtol=0)
    # params_from_jax gives back the published layout
    again = tvg.load_state_dict(tvg.params_from_jax(jax.tree_util.tree_map(
        lambda x: x if isinstance(x, str) else np.asarray(x), params)), device="cpu")
    np.testing.assert_allclose(tvg.landscape(again, torch.from_numpy(emb)), want,
                               atol=HEAD_ATOL, rtol=0)
    with mock.patch.object(tvg, "LEAKY_SLOPE", 0.2):
        bad = tvg.landscape(head, torch.from_numpy(emb))
    assert np.abs(bad - want).max() > 10 * HEAD_ATOL


def test_teacher_distillation_step_by_step():
    d, seq = 24, _seq(30, 8)
    emb = np.random.RandomState(9).randn(len(seq), d).astype(np.float32)
    teacher = np.random.RandomState(10).randn(len(seq), 20).astype(np.float32)
    with jax.enable_x64(False):
        params = jvg.init_params(jax.random.PRNGKey(0), jvg.VespagConfig(embed_dim=d,
                                                                         hidden_dim=16))
        start = tvg.load_state_dict(tvg.params_from_jax(
            {k: v if k == "arch" else jax.tree_util.tree_map(np.asarray, v)
             for k, v in params.items()}), device="cpu")
        runs = {steps: jvg.train_from_teacher(params, emb, teacher, steps=steps)
                for steps in (1, 2, 3, 25)}
    for steps, jparams in runs.items():
        head = tvg.train_from_teacher(start, torch.from_numpy(emb), teacher, steps=steps)
        want = tvg.params_from_jax({k: v if k == "arch" else jax.tree_util.tree_map(
            np.asarray, v) for k, v in jparams.items()})
        got = tvg.state_dict_of(head)
        for key in want:
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                       atol=TRAIN_ATOL, rtol=0, err_msg=f"{key} at {steps}")
    with jax.enable_x64(False):
        want = jvg.score_mutants(runs[25], emb, seq, _mutants(seq, 11))
    np.testing.assert_allclose(tvg.score_mutants(head, torch.from_numpy(emb), seq,
                                                 _mutants(seq, 11)), want, atol=1e-4, rtol=0)
    # the start is left as it was, and ten times the learning rate fails
    assert torch.equal(tvg.state_dict_of(start)["net.0.weight"],
                       tvg.load_state_dict(tvg.state_dict_of(start), device="cpu")["net"][0][0])
    bad = tvg.state_dict_of(tvg.train_from_teacher(start, torch.from_numpy(emb), teacher,
                                                   steps=3, learning_rate=1e-2))
    want3 = tvg.params_from_jax({k: v if k == "arch" else jax.tree_util.tree_map(
        np.asarray, v) for k, v in runs[3].items()})
    assert np.abs(bad["net.0.weight"].numpy() - want3["net.0.weight"].numpy()).max() \
        > 10 * TRAIN_ATOL
