"""A configuration, a traffic mix, a metric and a cell's limits dropped
into a copy of the folder are found by their names."""

import json

import pytest

from h100bench.bench import load_cell
from tiny import CONFIGS, make_tree


def test_new_files_are_found_by_name(tmp_path):
    cfg = dict(CONFIGS["esm2_tiny"], num_layers=1)
    root = make_tree(tmp_path, configs={"esm2_other": cfg},
                     cells={"esm2_other.tiny_packed": ("esm2_other", "tiny_packed")})
    here = root / "h100bench"
    (here / "traffic" / "brand_new.json").write_text(json.dumps(
        {"kind": "assay_masked_marginals", "lengths": [25], "doubles_per_residue": 0,
         "chunk": 4, "pool": 1, "profile": {"skip": 0, "calls": 1}, "check": {"per_length": 2}}))
    (here / "metrics" / "calls.count.py").write_text("def read(r):\n    return len(r.records)\n")
    (here / "checks" / "esm2_other.brand_new.json").write_text(
        json.dumps({"limits": {"max_score_gap": {"limit": 0.5}}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "esm2_other.brand_new", "config": "esm2_other",
                               "traffic": "brand_new", "chips": 1, "why": "tests"})
    bench["per_layer"].append({"name": "calls.count", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "scoring harness",
                               "moves": "mutants_per_s", "workloads": ["esm2_other.brand_new"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = load_cell(root, "esm2_other.brand_new")
    assert cell.config["num_layers"] == 1
    assert cell.traffic["lengths"] == [25]
    assert cell.kind.__file__ == str(here / "kinds" / "assay_masked_marginals.py")
    assert cell.family.__file__ == str(here / "families" / "esm2.py")
    assert "calls.count" in cell.readers
    assert cell.limits == {"max_score_gap": 0.5}
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]  # the others list their cells


def test_unknown_cell_is_refused(tmp_path):
    with pytest.raises(KeyError):
        load_cell(make_tree(tmp_path), "esm2_tiny.nowhere")


def test_a_split_metric_reads_its_quantity(tmp_path):
    """``pad_share.short`` is read by ``metrics/pad_share.py`` unless it has
    a file of its own."""
    root = make_tree(tmp_path)
    here = root / "h100bench"
    cell = load_cell(root, "esm2_tiny.tiny_assay")
    assert cell.readers["pad_share.short"].__file__ == str(here / "metrics" / "pad_share.py")
    (here / "metrics" / "model_mfu.short.py").write_text("def read(r):\n    return 1.0\n")
    cell = load_cell(root, "esm2_tiny.tiny_assay")
    assert cell.readers["model_mfu.short"].__file__ == str(here / "metrics" / "model_mfu.short.py")
