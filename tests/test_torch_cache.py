"""The port's content-addressed artifact cache (pipeline/cache.py) against
the JAX package's: the same inputs give the same hex key, and each reads
the other's files."""

import numpy as np
import pytest

from proteingym_tpu.pipeline import cache as jcache
from proteingym_tpu_torch.pipeline import cache as tcache

INPUTS = [
    dict(msa=np.arange(10.0), theta=0.2),
    dict(msa=np.arange(12, dtype=np.int8).reshape(3, 4), seed=3, name="BLAT"),
    dict(blob=b"\x00\x01", samples=[1, 2, 3], config={"b": 1, "a": 2.5}),
    dict(weights=np.zeros((0, 5), np.float32)),
]


@pytest.mark.parametrize("case", range(len(INPUTS)))
def test_content_key_equals_jax(case):
    assert tcache.content_key(**INPUTS[case]) == jcache.content_key(**INPUTS[case])


def test_key_sensitivity():
    a = np.arange(10.0)
    k1 = tcache.content_key(msa=a, theta=0.2)
    assert k1 != tcache.content_key(msa=a, theta=0.3)
    assert k1 != tcache.content_key(msa=a + 1, theta=0.2)
    assert k1 != tcache.content_key(msa=a.astype(np.float32), theta=0.2)
    assert k1 == tcache.content_key(theta=0.2, msa=np.arange(10.0))


def test_get_or_compute_shares_files_with_jax(tmp_path):
    calls = []

    def compute():
        calls.append(1)
        return {"weights": np.ones(5), "neff": np.asarray(3.2)}

    port = tcache.ArtifactCache(tmp_path)
    out1 = port.get_or_compute("weights", compute, msa_hash="abc", theta=0.2)
    out2 = port.get_or_compute("weights", compute, msa_hash="abc", theta=0.2)
    assert len(calls) == 1
    np.testing.assert_array_equal(out1["weights"], out2["weights"])
    # the JAX cache finds the port's file, and the port the JAX cache's
    assert float(jcache.ArtifactCache(tmp_path).get_or_compute(
        "weights", compute, msa_hash="abc", theta=0.2)["neff"]) == 3.2
    jcache.ArtifactCache(tmp_path).put("weights", jcache.content_key(x=1), w=np.arange(3))
    np.testing.assert_array_equal(port.get("weights", tcache.content_key(x=1))["w"], np.arange(3))
    assert len(calls) == 1
    port.get_or_compute("weights", compute, msa_hash="xyz", theta=0.2)
    assert len(calls) == 2


def test_default_cache_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("PGYM_CACHE", str(tmp_path / "c"))
    assert tcache.ArtifactCache().root == tmp_path / "c" == jcache.ArtifactCache().root
