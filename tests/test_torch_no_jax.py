"""The port's runtime rule: it imports neither jax nor pandas (the GPU host
has neither), and chip_smoke.py refuses to run without a GPU."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _run(code, cwd=REPO):
    env = {**os.environ, "PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)


def test_port_imports_without_jax_or_pandas():
    proc = _run("""
        import sys
        sys.modules["jax"] = None      # any import of them now raises
        sys.modules["pandas"] = None
        import proteingym_tpu_torch
        from proteingym_tpu_torch.pipeline import cli, scorers, checkpoints
        from proteingym_tpu_torch.models import esm2, esm_scoring, packed_scoring, poet
        from proteingym_tpu_torch.msa import parser, weights
        from proteingym_tpu_torch.ops import flash_attention, rotary, gather_logprobs, _build
        from proteingym_tpu_torch.data import mutants, windows, reference, registry, table
        from proteingym_tpu_torch.metrics import core, bootstrap, aggregate, clinical
        from proteingym_tpu_torch.merge import merge
        registry.load_packaged_registry("DMS", "substitutions")  # reads the JSON by path
        shared = {m for m in sys.modules if m.startswith("proteingym_tpu.")}
        assert shared <= {"proteingym_tpu.pipeline", "proteingym_tpu.pipeline.manifest",
                          "proteingym_tpu.pipeline.telemetry",
                          "proteingym_tpu.constants"}, shared
        print("ok")
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
