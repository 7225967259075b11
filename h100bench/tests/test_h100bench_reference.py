"""Each family's plain reference against the port on the CPU, in float32:
the port's ``esm2_tiny`` preset and ProGen2 at a tiny shape, from weights
the benchmark draws in the published names."""

import numpy as np
import pytest
import torch

from h100bench.families import esm2, progen2
from h100bench.precision import Precision
from tiny import CONFIGS

ESM2_TINY = dict(CONFIGS["esm2_tiny"], model="esm2_tiny", num_layers=2, embed_dim=128,
                 num_heads=4, ffn_dim=512)


def _esm_rows():
    rs = np.random.RandomState(0)
    rows = np.stack([esm2.tokenize("".join(rs.choice(list("ACDEFGHIKLMNPQRSTVWY"), 40)))
                     for _ in range(3)])
    rows[0, 5] = rows[1, 17] = esm2.MASK  # masked rows, as the protocol runs them
    return torch.as_tensor(rows)


def test_esm2_reference_matches_port():
    from proteingym_tpu_torch.models.esm2 import PRESETS

    port = PRESETS["esm2_tiny"]
    assert (port.num_layers, port.embed_dim, port.num_heads) == (2, 128, 4)
    weights = esm2.make_weights(ESM2_TINY, 7, "cpu")
    program = esm2.build(ESM2_TINY, weights, "cpu")
    rows = _esm_rows()
    got = program.model(rows)
    want = esm2.Reference(ESM2_TINY, weights, "cpu").logits(rows)
    assert got.dtype == want.dtype == torch.float32
    assert (got - want).abs().max().item() < 1e-4
    assert want.std().item() > 0.1  # log-probs far from saturated


def test_progen2_reference_matches_port():
    cfg = CONFIGS["progen2_tiny"]
    weights = progen2.make_weights(cfg, 7, "cpu")
    program = progen2.build(cfg, weights, "cpu")
    rows = torch.as_tensor(np.stack([progen2.tokenize("MKVLAAGICWHHPQRSTYDE" * 2)[::k][:20]
                                     for k in (1, 2)]))
    got = program.logits_fn(rows)
    want = progen2.Reference(cfg, weights, "cpu").letter_logits(rows)
    assert got.shape == want.shape == (2, 20, 25)
    assert (got - want).abs().max().item() < 1e-4


def test_control_rounds_every_kind_of_product():
    g = torch.Generator().manual_seed(0)
    sign = torch.where(torch.rand(64, 64, generator=g) < 0.5, -1.0, 1.0)
    x = sign * (torch.rand(64, 64, generator=g) + 0.5)  # one binade's range: no fp8 subnormals
    for name, step in (("fp8", 2 ** -4), ("tf32", 2 ** -11), ("bf16", 2 ** -8)):
        prec = Precision({"dense": name})
        err = (prec.mm("dense", x, torch.eye(64)) - x).abs() / x.abs()
        assert 0 < err.max().item() <= step * 1.01
        assert (prec.mm("attention", x, torch.eye(64)) - x).abs().max().item() == 0


@pytest.mark.parametrize("family", [esm2, progen2])
def test_weights_are_the_same_from_the_same_seed(family):
    cfg = ESM2_TINY if family is esm2 else CONFIGS["progen2_tiny"]
    a, b = family.make_weights(cfg, 2 ** 40 + 3, "cpu"), family.make_weights(cfg, 2 ** 40 + 3, "cpu")
    c = family.make_weights(cfg, 2 ** 40 + 4, "cpu")
    assert a.keys() == b.keys() == c.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed_tokens.weight" if family is esm2 else "transformer.wte.weight"],
                           c["embed_tokens.weight" if family is esm2 else "transformer.wte.weight"])
