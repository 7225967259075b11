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
    # every module of the port, found by walking the package; afterwards no
    # module of the JAX package may be loaded, not even a stdlib-only one
    proc = _run("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None      # any import of them now raises
        sys.modules["pandas"] = None
        import proteingym_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(proteingym_tpu_torch.__path__,
                                                       "proteingym_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        from proteingym_tpu_torch.data import registry
        registry.load_packaged_registry("DMS", "substitutions")  # the port's own JSON
        jax_package = sorted(m for m in sys.modules
                             if m == "proteingym_tpu" or m.startswith("proteingym_tpu."))
        assert not jax_package, jax_package
        assert "proteingym_tpu_torch.pipeline.cli" in names and len(names) > 30, names
        assert "proteingym_tpu_torch.models.wavenet" in names, names
        new = {"proteingym_tpu_torch.models." + m for m in ("gemme", "siterm", "rsalor",
                                                             "provean")}
        new |= {"proteingym_tpu_torch.data.structures", "proteingym_tpu_torch.msa.columns"}
        new |= {"proteingym_tpu_torch.models." + m for m in ("ar_zoo", "progen3", "unirep")}
        new |= {"proteingym_tpu_torch.models." + m for m in ("esmc", "esm3", "xtrimo", "carp")}
        new |= {"proteingym_tpu_torch.models." + m for m in ("gvp_transformer", "protein_mpnn",
                                                             "saprot")}
        new |= {"proteingym_tpu_torch.ops.tridi"}
        new |= {"proteingym_tpu_torch.models." + m for m in ("prosst", "prosst_quantizer", "mulan",
                                                             "structure_plms")}
        new |= {"proteingym_tpu_torch.ops.gvp", "proteingym_tpu_torch.ops.gnn",
                "proteingym_tpu_torch.models.state_dict"}
        new |= {"proteingym_tpu_torch.models." + m for m in ("protssn", "s3f")}
        new |= {"proteingym_tpu_torch.models." + m for m in (
            "prot_t5", "vespa_heads", "vespag", "supervised_baselines", "protein_npt", "kermut")}
        new |= {"proteingym_tpu_torch.merge.supervised", "proteingym_tpu_torch.metrics.supervised"}
        new |= {"proteingym_tpu_torch.models.esm_train", "proteingym_tpu_torch.parallel.mesh",
                "proteingym_tpu_torch.parallel.dryrun", "proteingym_tpu_torch.ops.ring_attention",
                "proteingym_tpu_torch.pipeline.profiler", "proteingym_tpu_torch.pipeline.cache",
                "proteingym_tpu_torch.data.download", "proteingym_tpu_torch.data.cleanup"}
        assert new <= set(names), sorted(new - set(names))
        print("ok")
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_native_imports_without_a_compiler(tmp_path):
    # the host library's module (and every module that imports it) loads
    # with no g++ on PATH and builds nothing: each library is built at
    # first use
    env = {**os.environ, "PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": "",
           "PATH": str(tmp_path)}
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        from proteingym_tpu_torch import native
        from proteingym_tpu_torch.models import hmm, potts, retrieval, trancepteve, wavenet
        from proteingym_tpu_torch.models import gemme, provean, rsalor, siterm
        from proteingym_tpu_torch.models import ar_zoo, progen3, unirep
        from proteingym_tpu_torch.models import carp, esm3, esmc, xtrimo
        from proteingym_tpu_torch.models import gvp_transformer, protein_mpnn, saprot
        from proteingym_tpu_torch.models import mulan, prosst, prosst_quantizer, structure_plms
        from proteingym_tpu_torch.models import protssn, s3f
        from proteingym_tpu_torch.models import kermut, prot_t5, protein_npt, vespa_heads, vespag
        from proteingym_tpu_torch.models import supervised_baselines
        from proteingym_tpu_torch.merge import supervised
        from proteingym_tpu_torch.metrics import supervised as supervised_metrics
        from proteingym_tpu_torch.pipeline import scorers
        from proteingym_tpu_torch.data import cleanup
        assert native._lib is None and native._nj_lib is None and native._hhfilter_lib is None
        assert {"hmm", "potts", "evmutation", "site_independent", "wavenet", "gemme", "escott",
                "siterm", "rsalor", "provean", "progen2", "rita", "protgpt2", "progen3",
                "unirep", "esmc", "esm3", "xtrimopglm", "carp", "esm_if1", "protein_mpnn",
                "saprot", "prosst", "venusrem", "mulan", "mif", "mif_st", "protssn", "s2f", "s3f",
                "s3f_msa", "aido", "vespa", "vespag", "ohe_ridge", "embeddings_ridge",
                "proteinnpt", "kermut"} <= set(scorers.SCORERS)
        assert len(scorers.SCORERS) == 45
        print("ok")
    """)], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
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
