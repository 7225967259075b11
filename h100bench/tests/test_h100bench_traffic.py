"""The traffic: the same seed gives the same inputs, and the ladders are
as the mixes state."""

import json

import pytest

from h100bench.bench import load_module
from tiny import HERE

BIG = 2 ** 31 + 12_345  # seeds go past 32 signed bits


def _mix(name):
    traffic = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    return traffic, load_module(HERE / "kinds" / f"{traffic['kind']}.py")


@pytest.mark.parametrize("mix", ["packed_sweep", "assay_short", "singles"])
def test_lengths_are_the_named_assays(mix):
    traffic, _ = _mix(mix)
    assert traffic["lengths"] == [n for _, _, n in traffic["assays"]]


def test_packed_sweep_ladder_and_counts():
    traffic, kind = _mix("packed_sweep")
    pool = kind.make_pool(traffic, {}, BIG)
    assert len(pool) == traffic["pool"]
    for payload in pool:
        assert [len(s) for s, _ in payload] == [101, 189, 393, 709, 1863]
        assert kind.mutant_count(payload) == 19 * sum(len(s) for s, _ in payload) == 61_845
        for seq, muts in payload:
            assert len(set(muts)) == len(muts) == 19 * len(seq)
            assert not any(":" in m for m in muts)


def test_assay_short_ladder_and_counts():
    traffic, kind = _mix("assay_short")
    pool = kind.make_pool(traffic, {}, BIG)
    lengths = [len(p[0][0]) for p in pool]
    assert lengths == [101, 149, 158, 163, 164, 189, 217, 243, 245] * traffic["pool"]
    assert sum(kind.mutant_count(p) for p in pool[:9]) == 30_951


def test_ar_whole_assays():
    traffic, kind = _mix("singles")
    pool = kind.make_pool(traffic, {}, BIG)
    assert [len(p["seq"]) for p in pool] == [101] * traffic["pool"]
    assert len({p["seq"] for p in pool}) == traffic["pool"]  # a fresh assay each call
    for p in pool:
        assert len(p["mutants"]) == 1_919 == len(set(p["mutated"]))
        assert not any(":" in m for m in p["mutants"])
        assert all(len(s) == len(p["seq"]) for s in p["mutated"])
    # the last, partial batch of a request is warmed up too
    assert kind.shapes(traffic, {}) == [(1_919 % 32, 128), (32, 128)]


def test_ar_doubles():
    traffic, kind = _mix("singles")
    traffic = dict(traffic, lengths=[30, 40], doubles_per_residue=0.1, pool=2)
    pool = kind.make_pool(traffic, {}, BIG)
    assert [len(p["seq"]) for p in pool] == [30, 40, 30, 40]
    for p in pool:
        n = len(p["seq"])
        assert len(p["mutants"]) == 19 * n + n // 10 == len(set(p["mutated"]))
        assert sum(":" in m for m in p["mutants"]) == n // 10


@pytest.mark.parametrize("mix", ["packed_sweep", "assay_short", "singles"])
def test_same_seed_same_traffic(mix):
    traffic, kind = _mix(mix)
    a, b = kind.make_pool(traffic, {}, BIG), kind.make_pool(traffic, {}, BIG)
    c = kind.make_pool(traffic, {}, BIG + 1)
    assert a == b
    assert a != c
    sizes = lambda pool: [kind.mutant_count(p) for p in pool]
    assert sizes(a) == sizes(c)  # another seed: other residues, the same work
