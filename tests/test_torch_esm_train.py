"""The port's ESM masked-LM trainer (proteingym_tpu_torch.models.esm_train)
against the JAX ``esm_train`` on the same weights and masks, and the
kernel entries' refusal of autograd.

The weights cross as one seeded fair-esm state dict (numpy), which each
side loads natively. The JAX side runs float32 inside
``jax.enable_x64(False)`` (its production dtype); its ``mask_batch`` draws
each step's masks, which both sides then use; its step is compiled once at
XLA's lowest optimisation level (seconds fewer to compile, the same
float32 operations). Tolerance: 1e-5 on the losses and on every parameter
after three AdamW steps (float32 sums in other orders; an AdamW step moves
a weight by about lr = 1e-4).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.models import esm2 as jesm
from proteingym_tpu.models import esm_train as jtrain
from proteingym_tpu_torch.models import esm2 as tesm
from proteingym_tpu_torch.models import esm_train as ttrain
from proteingym_tpu_torch.ops import flash_attention as fa
from tests.test_torch_esm2 import fair_esm_state
from tests.test_torch_eve_train import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ATOL = 1e-5
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
STEPS = 3
SEQS = ["MKTAYIAKQRQISFVKSHFSRQLEERLGLIEV", "MKTAYIAKQRQISFVKSHF", "GDGTQDNLSGAEKAVQ"]


def _world():
    cfg_j, cfg_t = jesm.PRESETS["esm2_tiny"], tesm.PRESETS["esm2_tiny"]
    sd = fair_esm_state(cfg_t, 0)
    params = jesm.convert_torch_state_dict(sd, cfg_j)
    tokens = np.stack([jesm.ALPHABET.tokenize(s, pad_to=40) for s in SEQS])
    weights = np.asarray([1.0, 0.5, 2.0], np.float32)
    model = tesm.load_fair_esm_state_dict(sd, cfg_t, device="cpu")
    return cfg_j, cfg_t, params, tokens, weights, model


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX AdamW steps: each step's masks, loss and the final params."""
    cfg_j, cfg_t, params, tokens, weights, model = _world()
    with jax.enable_x64(False):
        init_opt, step = jtrain.make_train_step(cfg_j)
        p, opt = jax.tree_util.tree_map(jnp.asarray, params), init_opt(params)
        toks, w = jnp.asarray(tokens), jnp.asarray(weights)
        rngs = [jax.random.PRNGKey(100 + i) for i in range(STEPS)]
        step = jax.jit(step).lower(p, opt, rngs[0], toks, w).compile(FAST_COMPILE)
        draw = jax.jit(jtrain.mask_batch).lower(rngs[0], toks).compile(FAST_COMPILE)
        masks, losses = [], []
        for rng in rngs:
            masked, target = draw(rng, toks)
            masks.append((np.array(masked), np.array(target)))
            p, opt, loss = step(p, opt, rng, toks, w)
            losses.append(float(loss))
        final = jax.device_get(p)
    return dict(cfg=cfg_t, model=model, tokens=tokens, weights=weights, masks=masks,
                losses=losses, final=tesm.params_from_jax(final, cfg_t))


def _torch_steps(run, config, steps=STEPS):
    init, step = ttrain.make_train_step(config)
    state = init(run["model"])
    tokens = torch.as_tensor(run["tokens"], dtype=torch.long)
    weights = torch.as_tensor(run["weights"])
    losses = []
    for masked, target in run["masks"][:steps]:
        losses.append(float(step(state, tokens, weights,
                                 masked=(torch.as_tensor(masked, dtype=torch.long),
                                         torch.as_tensor(target)))))
    return state, losses


def test_three_steps_match_jax(jax_run):
    state, losses = _torch_steps(jax_run, jax_run["cfg"])
    np.testing.assert_allclose(losses, jax_run["losses"], atol=ATOL, rtol=0)
    got = {k: v.detach() for k, v in state.model.state_dict().items()}
    assert set(got) == set(jax_run["final"])
    for name, want in jax_run["final"].items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(), atol=ATOL, rtol=0,
                                   err_msg=name)
    assert losses[0] > 0 and np.isfinite(losses).all()


def test_gradient_reaches_every_qkv_projection(jax_run):
    state, _ = _torch_steps(jax_run, jax_run["cfg"], steps=1)
    for name, p in state.model.named_parameters():
        if any(f"self_attn.{x}_proj.weight" in name for x in "qkv"):
            assert p.grad is not None and float(p.grad.abs().sum()) > 0, name


def test_remat_is_the_same_step(jax_run):
    import dataclasses

    _, plain = _torch_steps(jax_run, jax_run["cfg"], steps=2)
    _, remat = _torch_steps(jax_run, dataclasses.replace(jax_run["cfg"], remat=True), steps=2)
    np.testing.assert_allclose(remat, plain, atol=1e-6, rtol=0)


def test_bf16_masters_stay_float32(jax_run):
    # bf16 compute: the dense weights reach the layers cast, the masters
    # (and so AdamW's state) are float32 and take the gradient
    import dataclasses

    cfg = dataclasses.replace(jax_run["cfg"], dtype=torch.bfloat16)
    init, step = ttrain.make_train_step(cfg)
    state = init(jax_run["model"])
    q = state.model.layers[0].self_attn.q_proj
    assert q.weight.dtype == torch.bfloat16
    assert q.parametrizations.weight.original.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    before = q.parametrizations.weight.original.detach().clone()
    loss = step(state, torch.as_tensor(jax_run["tokens"], dtype=torch.long),
                generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(loss))
    assert not torch.equal(before, q.parametrizations.weight.original.detach())


def test_mask_batch_fractions():
    tokens = torch.as_tensor(np.stack([tesm.ALPHABET.tokenize("ACDEFGHIKLMNPQRSTVWY" * 25,
                                                              pad_to=520)] * 16),
                             dtype=torch.long)
    masked, select = ttrain.mask_batch(torch.Generator().manual_seed(3), tokens)
    special = (tokens == tesm.ALPHABET.cls_idx) | (tokens == tesm.ALPHABET.eos_idx) | \
        (tokens == tesm.ALPHABET.padding_idx)
    assert not (select & special).any()
    share = float(select.sum()) / float((~special).sum())
    assert abs(share - 0.15) < 0.01
    chosen = masked[select]
    assert abs(float((chosen == tesm.ALPHABET.mask_idx).float().mean()) - 0.8) < 0.03
    changed = chosen[chosen != tesm.ALPHABET.mask_idx]
    assert ((changed >= 4) & (changed < 24)).all()
    assert torch.equal(masked[~select], tokens[~select])


ENTRIES = {
    "grouped_mha": lambda q: fa.grouped_mha(q, q, q),
    "grouped_mha_bthd": lambda q: fa.grouped_mha_bthd(q, q, q),
    "flash_mha": lambda q: fa.flash_mha(q, q, q),
    "seg_block_mha": lambda q: fa.seg_block_mha(q, q, q, torch.ones(1, 8, dtype=torch.int32)),
    "rope_qk": lambda q: fa.rope_qk(q, q, 1.0, 10000.0),
    "mha": lambda q: fa.mha(q, q, q),
    "mha_natural": lambda q: fa.mha_natural(q, q, q),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_kernel_entries_refuse_autograd(entry):
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ENTRIES[entry](q)
    with torch.no_grad():  # grad mode off: the entry runs
        ENTRIES[entry](q)
    ENTRIES[entry](q.detach())  # nothing requires a gradient: it runs
