"""The import guard, by top-level name as a whole word, and what a run
does where it may not measure."""

import json
import shutil
import subprocess
import sys
import textwrap

from h100bench.guard import forbidden_modules
from tiny import HERE, REPO, make_tree


def test_guard_compares_whole_top_level_names():
    names = ["proteingym_tpu_torch", "proteingym_tpu_torch.models.esm2", "jaxtyping",
             "flaxen", "proteingym_tpu", "proteingym_tpu.ops", "jax.numpy", "jaxlib", "flax.linen"]
    assert forbidden_modules(names) == ["flax.linen", "jax.numpy", "jaxlib", "proteingym_tpu",
                                        "proteingym_tpu.ops"]


def test_a_whole_run_loads_no_jax(tmp_path):
    """A traced run of each tiny cell on the CPU, in a fresh process, then
    the modules it holds."""
    root = make_tree(tmp_path / "tree")
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        from h100bench import run
        from h100bench.bench import load_cell
        from h100bench.guard import forbidden_modules
        for cell in ("esm2_tiny.tiny_packed", "progen2_tiny.tiny_ar"):
            result, _ = run.run_cell(load_cell({str(root)!r}, cell), 5, 0.2, True, "cpu")
            assert result["correct"], result
        print("FORBIDDEN", forbidden_modules())
        print("PORT", "proteingym_tpu_torch" in sys.modules)
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
    assert "PORT True" in out.stdout


def test_no_card_no_result(tmp_path):
    """Without a CUDA device the run exits with another code than 0 and
    prints nothing on standard output."""
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                          "esm2_650m.packed_sweep", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_alone_is_no_run(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, the run exits with another code than 0 and prints no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "h100bench/run.py", "--workload",
                          "esm2_650m.packed_sweep", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())["paths"] == ["h100bench"]
