"""The port's CARP (proteingym_tpu_torch.models.carp) against the JAX
package's, in float32: ``apply`` on the JAX init pytree (made random in
every leaf) through ``params_from_jax``, ``apply_converted`` on synthetic
zenodo-layout state dicts (the one of tests/test_breadth_models.py, and
variants without an up-embedder or final norm, with plain Linear
feed-forwards), the op programs read from the shapes, and both strategies
of ``score_assay`` with the division by the number of mutated positions,
on native and on converted weights.

The JAX side runs inside ``jax.enable_x64(False)`` (under x64 its init
and ``np.sqrt`` scales are float64).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.models import carp as jc
from proteingym_tpu_torch.models import carp as tc
from tests.test_torch_esm3 import _randomize
from tests.test_torch_esmc import CPU, F32
from tests.test_torch_eve_train import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

# float32 on both sides; only summation orders differ (~1e-6 relative on
# logits of magnitude ~1-10)
ATOL = 1e-4
SCORE_ATOL = 1e-4
AA = "ACDEFGHIKLMNPQRSTVWY"
JCFG = jc.CarpConfig("tiny", num_layers=3, embed_dim=32, dtype=jnp.float32)
TCFG = tc.CarpConfig("tiny", num_layers=3, embed_dim=32, dtype=torch.float32)


def zenodo_state(d_emb=8, d=32, n_layers=2, k=5, vocab=30, up=True, last_norm=True,
                 linear_pff=False, seed=0):
    """A random zenodo ``carp_*.pt`` state dict (sequence_models ByteNetLM
    layout): sequence1 = [LN, GELU, PFF, LN, GELU], conv, sequence2 =
    [LN, GELU, PFF]; PFFs as (out, in, 1) convolutions or, with
    ``linear_pff``, (out, in) Linear weights."""
    rng = np.random.default_rng(seed)
    w = lambda *shape, scale=0.3: (rng.standard_normal(shape) * scale).astype(np.float32)
    pff = lambda n_out, n_in: w(n_out, n_in, scale=n_in ** -0.5) if linear_pff else \
        w(n_out, n_in, 1, scale=n_in ** -0.5)
    pff_key = "weight" if linear_pff else "conv.weight"
    sd = {"embedder.embedder.weight": w(vocab, d_emb if up else d, scale=1.0),
          "decoder.conv.weight": w(vocab, d, 1, scale=d ** -0.5),
          "decoder.conv.bias": w(vocab, scale=0.1)}
    if up:
        sd["embedder.up_embedder.conv.weight"] = w(d, d_emb, 1, scale=d_emb ** -0.5)
    if last_norm:
        sd["last_norm.weight"], sd["last_norm.bias"] = 1 + w(d, scale=0.1), w(d, scale=0.1)
    dh = d // 2
    for i in range(n_layers):
        b = f"embedder.layers.{i}"
        for name, dim in (("sequence1.0", d), ("sequence1.3", dh), ("sequence2.0", dh)):
            sd[f"{b}.{name}.weight"], sd[f"{b}.{name}.bias"] = 1 + w(dim, scale=0.1), w(dim, scale=0.1)
        sd[f"{b}.sequence1.2.{pff_key}"] = pff(dh, d)
        sd[f"{b}.conv.conv.weight"] = w(dh, dh, k, scale=(k * dh) ** -0.5)
        sd[f"{b}.conv.conv.bias"] = w(dh, scale=0.1)
        sd[f"{b}.sequence2.2.{pff_key}"] = pff(d, dh)
        sd[f"{b}.sequence2.2.{pff_key.replace('weight', 'bias')}"] = w(d, scale=0.1)
    return sd


def converted(sd, seed_prefix=False):
    jsd = {("module." + k if seed_prefix else k): v for k, v in sd.items()}
    with F32():
        params = jc.convert_torch_state_dict(jsd, JCFG)
    model = tc.convert_torch_state_dict({k: torch.from_numpy(v) for k, v in jsd.items()}, TCFG,
                                        device=CPU)
    return params, model


def native(seed=0):
    with F32():
        host = _randomize(jc.init_params(jax.random.PRNGKey(seed), JCFG), seed)
    return host, tc.convert_torch_state_dict(tc.params_from_jax(host, TCFG), TCFG, device=CPU)


def _tokens(n=2, length=23, seed=1):
    return np.random.RandomState(seed).randint(0, 30, (n, length))


def test_apply_matches_jax():
    params, model = native(seed=2)
    toks = _tokens()
    with F32():
        want = np.asarray(jc.apply(params, JCFG, jnp.asarray(toks)))
    with torch.no_grad():
        got = model(torch.from_numpy(toks).long()).numpy()
    assert got.shape == (2, 23, 30)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("variant", [
    dict(), dict(up=False), dict(last_norm=False), dict(linear_pff=True), dict(n_layers=10),
], ids=["zenodo", "no_up_embedder", "no_last_norm", "linear_pff", "ten_blocks"])
def test_apply_converted_matches_jax(variant):
    sd = zenodo_state(seed=3, **variant)
    params, model = converted(sd, seed_prefix=True)
    toks = _tokens(seed=4)
    with F32():
        want = np.asarray(jc.apply_converted(params, JCFG, jnp.asarray(toks)))
    with torch.no_grad():
        got = model(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # the op programs read from the shapes, as the JAX converter reads them
    kinds = lambda ops: ["ln" if "ln" in op else "ff" for op in ops]
    names = {"ln": "LnGelu", "ff": "FeedForward"}
    ops = lambda seq: [type(m).__name__ for m in seq if not isinstance(m, torch.nn.Identity)]
    for block, ours in zip(params["blocks"], model.embedder.layers):
        assert ops(ours.sequence1) == [names[k] for k in kinds(block["pre"])]
        assert ops(ours.sequence2) == [names[k] for k in kinds(block["post"])]
    assert len(model.embedder.layers) == len(params["blocks"])
    assert hasattr(model.embedder, "up_embedder") == ("up" in params)
    assert hasattr(model, "last_norm") == ("final_ln" in params)


def test_dilations_cycle_to_the_maximum():
    sched = tc._dilation_schedule(tc.CARP_PRESETS["carp_640M"])
    assert sched == jc._dilation_schedule(jc.CARP_PRESETS["carp_640M"])
    assert sched[:9] == [1, 2, 4, 8, 16, 32, 64, 128, 1] and len(sched) == 56
    model = tc.convert_torch_state_dict(
        {k: torch.from_numpy(v) for k, v in zenodo_state(n_layers=10).items()}, TCFG, device=CPU)
    assert [b.conv.conv.dilation for b in model.embedder.layers] == \
        [1, 2, 4, 8, 16, 32, 64, 128, 1, 2]


def _assay(length=20, seed=5):
    rng = np.random.default_rng(seed)
    seq = "".join(rng.choice(list(AA), length))
    muts = [f"{seq[p]}{p + 1}{a}" for p in range(0, length, 3) for a in "AW" if a != seq[p]]
    return seq, muts + [f"{seq[1]}2K:{seq[6]}7P:{seq[9]}10G", f"{seq[0]}1{seq[0]}"]


@pytest.mark.parametrize("strategy", ["masked-marginals", "wt-marginals"])
@pytest.mark.parametrize("weights", ["native", "converted"])
def test_score_assay_matches_jax(strategy, weights):
    params, model = native(seed=6) if weights == "native" else converted(zenodo_state(seed=7))
    seq, muts = _assay()
    with F32():
        want = jc.score_assay(params, JCFG, seq, muts, strategy=strategy, chunk=6)
    got = tc.score_assay(model, seq, muts, strategy=strategy, chunk=6)
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)
    # the triple mutant is the mean of its three positions' differences
    singles = tc.score_assay(model, seq, muts[-2].split(":"), strategy=strategy, chunk=6)
    np.testing.assert_allclose(got[-2], singles.mean(), atol=1e-6, rtol=0)
    assert got[-1] == 0.0


def test_wt_row_raises_as_in_jax():
    _, model = native(seed=8)
    seq, _ = _assay()
    with pytest.raises(ValueError):
        tc.score_assay(model, seq, ["WT"])
    with pytest.raises(ValueError, match="WT mismatch"):
        tc.score_assay(model, seq, [f"{'A' if seq[0] != 'A' else 'C'}1G"])


def test_bf16_preset_keeps_the_jax_dtypes():
    model = tc.init_random(dataclasses.replace(tc.CARP_PRESETS["carp_600k"], num_layers=2),
                           seed=0, device=CPU)
    dtypes = {name: p.dtype for name, p in model.named_parameters()}
    assert dtypes["embedder.embedder.weight"] == torch.bfloat16
    assert dtypes["embedder.layers.0.sequence1.2.weight"] == torch.bfloat16
    assert dtypes["embedder.layers.0.conv.conv.weight"] == torch.float32
    assert dtypes["decoder.conv.weight"] == torch.float32
    with torch.no_grad():
        out = model(torch.from_numpy(_tokens(1, 12)).long())
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    # the init's scales: N(0, 2 / n_in) feed-forwards and head, N(0, 2 / (k d/2)) convolutions
    std = lambda name: float(dict(model.named_parameters())[name].float().std())
    assert abs(std("embedder.layers.0.sequence1.2.weight") / np.sqrt(2 / 128) - 1) < 0.1
    assert abs(std("embedder.layers.0.conv.conv.weight") / np.sqrt(2 / (5 * 64)) - 1) < 0.1


@pytest.mark.parametrize("strategy", ["masked-marginals", "wt-marginals"])
def test_scorer_column_matches_jax(monkeypatch, strategy):
    from proteingym_tpu.pipeline import scorers_extra as jextra
    from proteingym_tpu_torch.pipeline import scorers as tscorers
    from tests.test_torch_esmc import scorer_contexts

    params, model = native(seed=9)
    seq, muts = _assay(24, 10)
    monkeypatch.setitem(jc.CARP_PRESETS, "tiny32", JCFG)
    monkeypatch.setitem(tc.CARP_PRESETS, "tiny32", TCFG)
    monkeypatch.setattr(jc, "init_params", lambda rng, c: params)
    extra = {"scoring_strategy": strategy}
    jctx, tctx = scorer_contexts(seq, muts, "tiny32", extra,
                                 dict(extra, params=model.state_dict()))
    with F32():
        want = jextra.score_carp(jctx)["tiny_score"].to_numpy()
    got = tscorers.SCORERS["carp"](tctx)
    assert list(got) == ["tiny_score"]
    np.testing.assert_allclose(got["tiny_score"], want, atol=SCORE_ATOL, rtol=0)


def test_zenodo_file_through_the_scorer(tmp_path, monkeypatch):
    # a published file is read natively, its preset found by blocks and
    # width, and run in float32: the JAX converted path's numbers
    from proteingym_tpu_torch.pipeline import scorers as tscorers
    from tests.test_torch_esmc import scorer_contexts

    sd = zenodo_state(d=32, n_layers=3, seed=11)
    monkeypatch.setitem(tc.CARP_PRESETS, "tiny_bf16", dataclasses.replace(TCFG, dtype=torch.bfloat16))
    path = tmp_path / "carp_tiny.pt"
    torch.save({"model_state_dict": {"module." + k: torch.from_numpy(v) for k, v in sd.items()}},
               path)
    seq, muts = _assay(24, 12)
    params, _ = converted(sd)
    with F32():
        want = jc.score_assay(params, JCFG, seq, muts, chunk=4)
    _, tctx = scorer_contexts(seq, muts, str(path), {}, {})
    got = tscorers.SCORERS["carp"](tctx)
    assert list(got) == ["tiny_score"]  # the bf16 preset of that shape, run in float32
    np.testing.assert_allclose(got["tiny_score"], want, atol=SCORE_ATOL, rtol=0)
