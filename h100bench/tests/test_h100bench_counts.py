"""The operation and byte counts against hand counts."""

import json

import pytest
import torch

from h100bench import peaks, trace
from h100bench.families import esm2, progen2
from tiny import REPO


def _cfg(name):
    return json.loads((REPO / "h100bench" / "configs" / f"{name}.json").read_text())


def test_esm2_650m_forward_flops_at_252_tokens():
    # 33 x (2 * 252 * (4 * 1280^2 + 2 * 1280 * 5120) + 4 * 252^2 * 1280)
    #  + 2 * 252 * 1280^2 + 2 * 252 * 1280 * 33
    assert esm2.forward_flops(_cfg("esm2_650m"), 252) == 338_575_104_000


def test_esm2_650m_forward_bytes():
    # per layer 19,672,320 bf16 parameters and 4 x 1,280 float32 layer-norm
    # values: 39,365,120 bytes; x 33, + embeddings 84,480 + final LN 10,240
    # + head dense 3,279,360 + head LN 10,240 + head bias 132
    assert esm2.forward_bytes(_cfg("esm2_650m")) == 1_302_433_412


def test_progen2_xlarge_forward_flops_at_256_tokens():
    # 32 x (2 * 256 * (4 * 4096^2 + 2 * 4096 * 16384) + 2 * 256^2 * 4096)
    #  + 2 * 256 * 4096 * 32
    assert progen2.forward_flops(_cfg("progen2_xlarge"), 256) == 3_315_781_861_376


def test_progen2_xlarge_forward_bytes():
    # 32 x ((3 + 1 + 4 + 4) x 4096^2 bf16 + (16384 + 4096) float32 biases
    #  + 2 x 4096 float32 LN) + 32 x 4096 bf16 wte + float32 ln_f, lm_head
    d, f = 4096, 16384
    layer = 12 * d * d * 2 + (f + d) * 4 + 2 * d * 4
    total = 32 * layer + 32 * d * 2 + 2 * d * 4 + (32 * d + 32) * 4
    assert progen2.forward_bytes(_cfg("progen2_xlarge")) == total == 12_889_391_232


def test_attention_least_time_from_live_extents():
    """Two rows of 8 query/key slots, 8 and 5 live, H=20, D=64: 4 H D n^2
    operations and 8 H D n bytes per row; then causal halves the
    operations."""
    q = torch.zeros(2, 8, 20, 64)
    mask = torch.tensor([[True] * 8, [True] * 5 + [False] * 3])
    probe = trace.AttentionProbe(None, "x", "bthd")
    probe._record(q, {"key_mask": mask})
    flops = 4 * 20 * 64 * (8 * 8 + 5 * 5)
    nbytes = 8 * 20 * 64 * (8 + 5)
    want = max(flops / peaks.PEAK_BF16_FLOPS, nbytes / peaks.PEAK_BYTES_PER_S)
    assert probe.least_seconds() == pytest.approx(want, rel=1e-12)
    causal = trace.AttentionProbe(None, "x", "bhtd")
    causal._record(torch.zeros(3, 16, 256, 256), {"causal": True})
    want = max(4 * 16 * 256 * 256 ** 2 * 3 / 2 / peaks.PEAK_BF16_FLOPS,
               8 * 16 * 256 * 256 * 3 / peaks.PEAK_BYTES_PER_S)
    assert causal.least_seconds() == pytest.approx(want, rel=1e-12)


def test_attention_probe_declines_segments():
    probe = trace.AttentionProbe(None, "x", "bthd")
    probe._record(torch.zeros(1, 4, 2, 8), {"segment_ids": torch.ones(1, 4)})
    assert probe.least_seconds() is None
