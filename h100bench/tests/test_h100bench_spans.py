"""The readers of the port's spans: ``harness_host_share`` (the harness
spans' self seconds over the traced part, the waits left out) and
``attn_launch_us`` (the attention entry's host microseconds a call). Each
reads nothing from an empty record, from a run without a traced part and
from a port that keeps no record; a traced run at a size the CPU holds
reports the harness share of each cell."""

import types

import pytest

from h100bench import run
from h100bench.bench import load_cell, load_module, reader_path
from proteingym_tpu_torch.pipeline import profiler
from tiny import CELLS, HERE, make_tree

SEED = 2 ** 31 + 12345
READERS = {name: load_module(reader_path(HERE, name))
           for name in ("harness_host_share", "attn_launch_us")}

# {name: (count, seconds, self seconds)}: the read-back nests in the parse,
# the upload in the rows
SEEDED = {
    "pgym.harness.plan": (3, 0.30, 0.30),
    "pgym.harness.rows": (40, 5.20, 0.20),
    "pgym.harness.upload": (40, 5.00, 5.00),
    "pgym.harness.readback": (2, 5.00, 5.00),
    "pgym.harness.gather": (2, 0.10, 0.10),
    "pgym.harness.parse": (5, 4.40, 0.40),
    "pgym.launch.grouped_attention_bthd": (600, 0.036, 0.036),
    "pgym.launch.grouped_attention": (200, 0.004, 0.004),
    "pgym.launch.rope_qk": (100, 9.0, 9.0),
    "pgym.load": (1, 30.0, 30.0),
}


def _reading(window_s=10.0):
    part = None if window_s is None else types.SimpleNamespace(window_s=window_s, busy_s=1.0)
    return types.SimpleNamespace(part=part)


@pytest.mark.parametrize("name", sorted(READERS))
def test_nothing_to_read(name, monkeypatch):
    profiler.clear_spans()
    assert READERS[name].read(_reading()) is None  # empty record
    monkeypatch.setattr(profiler, "span_totals", lambda: dict(SEEDED))
    assert READERS[name].read(_reading(None)) is None  # no traced part
    monkeypatch.delattr(profiler, "span_totals")  # a port that keeps no record
    assert READERS[name].read(_reading()) is None


def test_seeded_record(monkeypatch):
    monkeypatch.setattr(profiler, "span_totals", lambda: dict(SEEDED))
    # (0.30 + 0.20 + 0.10 + 0.40) s of 10 s; the upload and read-back left out
    assert READERS["harness_host_share"].read(_reading()) == pytest.approx(10.0)
    # (0.036 + 0.004) s over 800 calls of the entry; rope_qk is not the entry
    assert READERS["attn_launch_us"].read(_reading()) == pytest.approx(50.0)
    only_readback = {"pgym.harness.readback": SEEDED["pgym.harness.readback"]}
    monkeypatch.setattr(profiler, "span_totals", lambda: only_readback)
    assert READERS["harness_host_share"].read(_reading()) is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("tree"))


@pytest.mark.parametrize("name", sorted(CELLS))
def test_traced_run_reports_the_harness_share(root, name):
    profiler.clear_spans()
    result, _ = run.run_cell(load_cell(root, name), SEED, 0.3, True, "cpu")
    share = "harness_host_share.short" if "assay" in name else "harness_host_share"
    assert result["correct"] and 0 < result["metrics"][share]["value"] < 100
    # the CPU runs the plain attention: no launch of the port's kernels
    assert "attn_launch_us.short" not in result["metrics"]
    profiler.clear_spans()
    untraced, _ = run.run_cell(load_cell(root, name), SEED, 0.3, False, "cpu")
    assert untraced["correct"] and profiler.span_totals() == {}
