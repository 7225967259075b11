"""The port's attention (proteingym_tpu_torch.ops.flash_attention) against the
JAX package's grouped_mha and flash_mha, run in Pallas interpret mode on the
CPU, and the dispatcher's routing.

Both sides get the same float32 inputs, made with numpy from a seed. On
CPU tensors the port's wrapper takes its plain PyTorch version, so these
tests hold the plain version (the kernel's reference on the card) to the
TPU kernel's semantics. The CUDA kernel itself is compared with the plain
version in tests/test_torch_cuda_kernels.py (GPU only) and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.ops import flash_attention as jfa
from proteingym_tpu_torch.ops import _build
from proteingym_tpu_torch.ops import flash_attention as tfa

B, H, D = 2, 4, 32
ATOL = 1e-5  # float32 on both sides; only summation order differs


def _qkv(seed, t, b=B, h=H, d=D, big_keys_from=None):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3))
    if big_keys_from is not None:
        k[:, :, big_keys_from:, :] *= 100.0  # masked keys with huge raw scores
    return q, k, v


def _lengths_mask(t, lengths):
    return np.arange(t)[None, :] < np.asarray(lengths)[:, None]


def _alibi(h, t):
    slopes = 2.0 ** (-8.0 * np.arange(1, h + 1) / h)
    return (slopes[:, None] * np.arange(t)[None, :]).astype(np.float32)  # >= 0


def _segments(t):
    seg = np.zeros((B, t), np.int32)
    seg[0, :12], seg[0, 12:30], seg[0, 30:35] = 1, 2, 3
    seg[1, :22] = 1
    return seg


# name -> (T, keyword arguments: numpy arrays or scalars)
CASES = {
    "plain": (40, {}),
    "padding": (40, {"key_mask": _lengths_mask(40, [40, 25])}),
    "masked_key_does_not_anchor_max": (40, {"key_mask": _lengths_mask(40, [30, 30])}),
    "fused_rope": (37, {"rope_base": 10000.0}),
    "rope_and_padding": (37, {"rope_base": 10000.0,
                              "key_mask": _lengths_mask(37, [37, 20])}),
    "segmented": (40, {"segment_ids": _segments(40), "key_mask": _segments(40) > 0}),
    "segmented_rope": (40, {"segment_ids": _segments(40), "key_mask": _segments(40) > 0,
                            "rope_base": 10000.0}),
    "causal": (24, {"causal": True}),
    "alibi_causal": (384, {"bias": _alibi(H, 384), "causal": True}),
    "bias_and_padding": (33, {"bias": _alibi(H, 33), "key_mask": _lengths_mask(33, [33, 10])}),
    # T a multiple of 128: the TPU kernel pads nothing, so its all-masked row
    # averages v over exactly the T keys, as the plain version does
    "all_masked_row": (128, {"key_mask": np.stack([np.ones(128, bool), np.zeros(128, bool)])}),
    "unaligned_T": (100, {"key_mask": _lengths_mask(100, [100, 77]), "rope_base": 10000.0}),
    "explicit_scale": (40, {"sm_scale": 0.3}),
}


def _run_both(q, k, v, kw, fn_jax, fn_torch):
    jkw = {n: jnp.asarray(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}
    tkw = {n: torch.from_numpy(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}
    want = np.asarray(fn_jax(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw))
    got = fn_torch(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **tkw)
    return got.numpy(), want


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_grouped_kernel(case):
    t, kw = CASES[case]
    q, k, v = _qkv(sorted(CASES).index(case), t,
                   big_keys_from=30 if case == "masked_key_does_not_anchor_max" else None)
    got, want = _run_both(
        q, k, v, kw,
        lambda *a, **j: jfa.grouped_mha(*a, interpret=True, **j),
        tfa.grouped_mha,
    )
    assert np.isfinite(got).all()
    if "segment_ids" in kw:
        # padding queries (segment 0) are never consumed; the TPU kernel
        # lets them attend to other pads, the plain version averages them
        live = kw["segment_ids"] > 0
        got, want = got.transpose(0, 2, 1, 3)[live], want.transpose(0, 2, 1, 3)[live]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["padding", "fused_rope", "segmented_rope", "causal"])
def test_dispatcher_matches_jax_mha_and_launches_nothing_on_cpu(case):
    t, kw = CASES[case]
    q, k, v = _qkv(7, t)
    got, want = _run_both(q, k, v, kw, jfa.mha, tfa.mha)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert set(tfa.LAUNCHES) == {"grouped_attention", "grouped_attention_bthd", "rope_qk",
                                 "flash_attention", "seg_block_attention"}
    assert all(n == 0 for n in tfa.LAUNCHES.values())


def test_reference_mha_matches_jax_reference():
    q, k, v = _qkv(3, 50)
    kw = {"key_mask": _lengths_mask(50, [50, 31]), "bias": _alibi(H, 50), "causal": True,
          "segment_ids": np.ones((B, 50), np.int32)}
    got, want = _run_both(q, k, v, kw, jfa.reference_mha, tfa.reference_mha)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_no_path_for_other_devices():
    q = torch.empty(1, 1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="no attention path"):
        tfa.grouped_mha(q, q, q)


# the long-context kernel: name -> (T, keyword arguments). No row has every
# key masked: there the TPU kernel averages v over its padded T.
FLASH_CASES = {
    "plain": (64, {}),
    "causal": (48, {"causal": True}),
    "padding_mask": (40, {"key_mask": _lengths_mask(40, [30, 10])}),
    "alibi_causal": (32, {"bias": -_alibi(H, 32), "causal": True}),
    "unaligned_T": (37, {}),
    "causal_mask_unaligned_T": (53, {"causal": True, "key_mask": _lengths_mask(53, [53, 20])}),
    "alibi_mask_scale": (45, {"bias": _alibi(H, 45), "key_mask": _lengths_mask(45, [45, 33]),
                              "sm_scale": 0.25}),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_jax_flash_kernel(case):
    t, kw = FLASH_CASES[case]
    q, k, v = _qkv(100 + sorted(FLASH_CASES).index(case), t)
    got, want = _run_both(
        q, k, v, kw,
        lambda *a, **j: jfa.flash_mha(*a, interpret=True, block_q=16, **j),
        tfa.flash_mha,
    )
    assert got.shape == want.shape == (B, H, t, D)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _recording(monkeypatch):
    calls = []
    for name in ("grouped_mha", "flash_mha"):
        fn = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _n=name, _f=fn, **k: calls.append(_n) or _f(*a, **k))
    return calls


@pytest.mark.parametrize("t,segmented,route", [
    (1024, False, "grouped_mha"),
    (1025, False, "flash_mha"),
    (1025, True, "grouped_mha"),
])
def test_dispatcher_routes_by_length_and_segments(monkeypatch, t, segmented, route):
    calls = _recording(monkeypatch)
    q = torch.zeros(1, 1, t, 16)
    seg = torch.ones(1, t, dtype=torch.int32) if segmented else None
    tfa.mha(q, q, q, causal=True, segment_ids=seg)
    assert calls == [route]


@pytest.mark.parametrize("case", ["flash_rope_mask_causal", "grouped_segments_rope"])
def test_dispatcher_long_rows_match_jax_mha(monkeypatch, case):
    # T > 1024 on both sides: the port routes to its long-context plain
    # version (after in-graph RoPE) or, with segments, to the grouped one;
    # the JAX dispatcher on the CPU takes its reference path for both
    t = 1100
    q, k, v = _qkv(11, t, b=1, h=2, d=16)
    if case == "flash_rope_mask_causal":
        kw = {"rope_base": 10000.0, "causal": True, "key_mask": _lengths_mask(t, [1050])}
    else:
        seg = np.zeros((1, t), np.int32)
        seg[0, :400], seg[0, 400:1090] = 1, 2
        kw = {"rope_base": 10000.0, "causal": True, "segment_ids": seg}
    calls = _recording(monkeypatch)
    got, want = _run_both(q, k, v, kw, jfa.mha, tfa.mha)
    assert calls == ["flash_mha" if case.startswith("flash") else "grouped_mha"]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_flash_no_path_for_other_devices():
    q = torch.empty(1, 1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="no attention path"):
        tfa.flash_mha(q, q, q)


def test_kernel_library_name_tracks_included_headers(tmp_path, monkeypatch):
    # a shared header is part of every library that includes it: editing it
    # renames (so rebuilds) each of them
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include <cuda_runtime.h>\n#include "common.cuh"\nint a;\n')
    (csrc / "b.cu").write_text('#include "common.cuh"\nint b;\n')
    (csrc / "common.cuh").write_text('#include "leaf.cuh"\n// v1\n')
    (csrc / "leaf.cuh").write_text("// leaf v1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert [f.name for f in _build.source_files("a")] == ["a.cu", "common.cuh", "leaf.cuh"]
    before = {n: _build.library_path(n) for n in ("a", "b")}
    (csrc / "leaf.cuh").write_text("// leaf v2\n")
    after = {n: _build.library_path(n) for n in ("a", "b")}
    assert all(before[n] != after[n] for n in before)
    assert after["a"].name.startswith("liba_") and after["a"].suffix == ".so"


def test_shipped_attention_kernels_share_one_header():
    # every attention kernel includes the common helpers; the mma.sync
    # loop's device code is shared by the grouped entries and the
    # extent-sparse one
    assert [f.name for f in _build.source_files("flash_attention")] == [
        "flash_attention.cu", "attention_common.cuh"]
    # the grouped entries (K1, K4) and the pre-pass add the Hopper loop;
    # the extent-sparse kernel (K3) keeps the mma.sync loop alone
    assert [f.name for f in _build.source_files("grouped_attention")] == [
        "grouped_attention.cu", "grouped_attention.cuh", "hopper_attention.cuh",
        "attention_common.cuh"]
    assert [f.name for f in _build.source_files("seg_block_attention")] == [
        "seg_block_attention.cu", "grouped_attention.cuh", "attention_common.cuh"]
    assert [f.name for f in _build.source_files("cluster_counts")] == ["cluster_counts.cu"]


def test_kernel_library_name_tracks_source():
    # the build is keyed by a hash of the source, so an edited kernel is
    # rebuilt and a stale library is never loaded
    path = _build.library_path("grouped_attention")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libgrouped_attention_") and path.suffix == ".so"
    assert (_build.CSRC / "grouped_attention.cu").exists()
