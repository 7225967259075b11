"""The port's ``merge``, ``evaluate`` and ``evaluate-clinical`` subcommands
against the JAX CLI's on the same inputs: the same CSVs; ``--device cuda``
raises without a GPU."""

import pytest
import torch

jax = pytest.importorskip("jax")

from proteingym_tpu.pipeline import cli as jcli
from proteingym_tpu_torch.pipeline import cli as tcli
from tests.test_torch_evaluate import (
    DATA_RTOL, assert_same_csvs, build_clinical_world, build_world,
)


def _both(args_for):
    assert jcli.main(args_for("jax")) == 0
    assert tcli.main(args_for("torch")) == 0


@pytest.mark.parametrize("mutation_type", ["substitutions", "indels"])
def test_merge_then_evaluate_clis_match(tmp_path, mutation_type):
    root = build_world(tmp_path, indels=mutation_type == "indels")
    _both(lambda pkg: [
        "merge", "--dms-reference", str(root / "reference.csv"), "--dms-dir", str(root / "dms"),
        "--scores-root", str(root / "scores"), "--config", str(root / "config.json"),
        "--output-dir", str(root / f"{pkg}_merged"), "--mutation-type", mutation_type])
    assert_same_csvs(root / "jax_merged", root / "torch_merged", DATA_RTOL)

    def evaluate(pkg):
        args = ["evaluate", "--dms-reference", str(root / "reference.csv"),
                "--merged-dir", str(root / f"{pkg}_merged"), "--config", str(root / "config.json"),
                "--constants", str(root / "constants.json"),
                "--output-dir", str(root / f"{pkg}_bench"), "--mutation-type", mutation_type,
                "--bootstrap-samples", "200", "--no-html"]
        return args + (["--device", "cpu"] if pkg == "torch" else [])

    _both(evaluate)
    assert assert_same_csvs(root / "jax_bench", root / "torch_bench") == 20
    assert not list((root / "torch_bench").rglob("*.html"))


def test_evaluate_writes_html_unless_told_not_to(tmp_path):
    root = build_world(tmp_path)
    assert tcli.main(["merge", "--dms-reference", str(root / "reference.csv"),
                      "--dms-dir", str(root / "dms"), "--scores-root", str(root / "scores"),
                      "--config", str(root / "config.json"),
                      "--output-dir", str(root / "merged")]) == 0
    assert tcli.main(["evaluate", "--dms-reference", str(root / "reference.csv"),
                      "--merged-dir", str(root / "merged"), "--config", str(root / "config.json"),
                      "--output-dir", str(root / "bench"), "--bootstrap-samples", "50",
                      "--device", "cpu"]) == 0
    html = sorted(p.name for p in (root / "bench" / "AUC").glob("*.html"))
    assert html == ["DMS_substitutions_AUC_DMS_level.html",
                    "Summary_performance_DMS_substitutions_AUC.html"]
    text = (root / "bench" / "AUC" / html[1]).read_text()
    assert text.startswith("<table") and "<th>Average_AUC</th>" in text


def test_evaluate_clinical_clis_match(tmp_path):
    root = build_clinical_world(tmp_path)

    def clinical(pkg):
        args = ["evaluate-clinical", "--clinical-reference", str(root / "clinical.csv"),
                "--merged-dir", str(root / "merged"), "--config", str(root / "config.json"),
                "--output-dir", str(root / f"{pkg}_bench"), "--bootstrap-samples", "200",
                "--no-html"]
        return args + (["--device", "cpu"] if pkg == "torch" else [])

    _both(clinical)
    assert assert_same_csvs(root / "jax_bench", root / "torch_bench") == 2


@pytest.mark.parametrize("command", ["evaluate", "evaluate-clinical"])
def test_cuda_device_without_gpu_raises(tmp_path, monkeypatch, command):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ref = "--dms-reference" if command == "evaluate" else "--clinical-reference"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main([command, ref, str(tmp_path / "ref.csv"), "--merged-dir", str(tmp_path),
                   "--output-dir", str(tmp_path / "out")])
