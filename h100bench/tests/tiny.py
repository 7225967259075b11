"""A benchmark tree at a size the CPU holds, for the tests: a temporary
copy of ``h100bench/`` with tiny configurations, tiny traffic mixes and a
``BENCHMARK.json`` that names them, found by the harness as a real cell's
files are."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent

_INIT = {"embed_std": 0.02, "bias_std": 0.02, "ln_std": 0.1, "ln_bias_std": 0.1}

CONFIGS = {
    "esm2_tiny": {
        "family": "esm2", "model": "esm2_tiny_bench", "source": "tests",
        "num_layers": 2, "embed_dim": 64, "num_heads": 4, "ffn_dim": 256, "alphabet_size": 33,
        "max_positions": 64, "rope_base": 10000.0, "token_dropout": True, "layer_norm_eps": 1e-5,
        "precision": {"weights": "float32"},
        "control": {"dense": "fp8", "attention": "fp8", "head": "tf32"},
        "init": dict(_INIT, dense_std=None), "reduced": []},
    "progen2_tiny": {
        "family": "progen2", "model": "progen2_tiny_bench", "source": "tests",
        "num_layers": 2, "embed_dim": 64, "num_heads": 4, "rotary_dim": 8, "ffn_dim": 256,
        "vocab_size": 32, "n_ctx": 64, "mp_num": 8, "layer_norm_eps": 1e-5,
        "precision": {"weights": "float32"},
        "control": {"dense": "fp8", "attention": "tf32", "head": "tf32"},
        "init": dict(_INIT, dense_std=0.02), "reduced": []},
}

TRAFFIC = {
    "tiny_packed": {"kind": "packed_masked_marginals", "lengths": [20, 70],
                    "doubles_per_residue": 1, "chunk": 8, "pool": 2,
                    "profile": {"skip": 0, "calls": 1}, "check": {"per_length": 20}},
    "tiny_assay": {"kind": "assay_masked_marginals", "lengths": [20, 30],
                   "doubles_per_residue": 1, "chunk": 8, "pool": 2,
                   "profile": {"skip": 0, "calls": 2}, "check": {"per_length": 20}},
    "tiny_ar": {"kind": "ar_mutants", "lengths": [12, 16], "doubles_per_residue": 0.25,
                "batch": 32, "pool": 2, "profile": {"skip": 0, "calls": 2},
                "check": {"per_length": 48}},
}

CELLS = {"esm2_tiny.tiny_packed": ("esm2_tiny", "tiny_packed"),
         "esm2_tiny.tiny_assay": ("esm2_tiny", "tiny_assay"),
         "progen2_tiny.tiny_ar": ("progen2_tiny", "tiny_ar")}

LIMIT = 1e-4  # float32 program against the float32 reference: ~5e-7 at these sizes


def make_tree(root: Path, configs=None, cells=None) -> Path:
    """``root`` with a copy of ``h100bench/`` and the tiny files added to
    it; returns ``root``."""
    configs = copy.deepcopy(configs or CONFIGS)
    cells = cells or CELLS
    shutil.copytree(HERE, root / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, cfg in configs.items():
        (root / "h100bench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, traffic in TRAFFIC.items():
        (root / "h100bench" / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    for cell in cells:
        (root / "h100bench" / "checks" / f"{cell}.json").write_text(
            json.dumps({"limits": {"max_score_gap": {"limit": LIMIT}}}))
    bench["configs"] = [{"name": n, "source": "tests", "file": f"h100bench/configs/{n}.json",
                         "reduced": [], "why": "tests"} for n in configs]
    bench["workloads"] = [{"name": c, "config": cfg, "traffic": t, "chips": 1, "why": "tests"}
                          for c, (cfg, t) in cells.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:  # the short-assay metrics go to the assay cells, the rest elsewhere
            short = m["name"] == "assay_s_p95" or m["name"].endswith(".short")
            m["workloads"] = [c for c in cells if ("assay" in c) == short]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
