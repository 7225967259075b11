"""The port's own copies of what it needs from the JAX package, held equal
to their originals: the constants by value, the packaged registry JSON by
bytes, and the manifest and event-log records as each package writes them.
The port imports none of the originals (tests/test_torch_no_jax.py)."""

import json
from pathlib import Path

import pytest

from proteingym_tpu import constants as jconst
from proteingym_tpu.pipeline import manifest as jmanifest
from proteingym_tpu.pipeline import telemetry as jtelemetry
from proteingym_tpu_torch import constants as tconst
from proteingym_tpu_torch.data import registry as tregistry
from proteingym_tpu_torch.pipeline import manifest as tmanifest
from proteingym_tpu_torch.pipeline import telemetry as ttelemetry

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", ["AA_VOCAB", "GAP", "ALPHABET_PROTEIN_NOGAP",
                                  "ALPHABET_PROTEIN_GAP", "MUTATION_DEPTHS", "METRICS"])
def test_constant_equals_the_jax_packages(name):
    assert getattr(tconst, name) == getattr(jconst, name)


def test_port_constants_are_a_subset_of_the_jax_packages():
    names = {n for n in vars(tconst) if n.isupper()}
    assert names and all(getattr(tconst, n) == getattr(jconst, n) for n in names)


@pytest.mark.parametrize("name", ["registry.json", "display.json"])
def test_packaged_json_equals_the_jax_packages_bytes(name):
    port = tregistry.CONFIGS_DIR / name
    assert port.parent == REPO / "proteingym_tpu_torch" / "configs"
    assert port.read_bytes() == (REPO / "proteingym_tpu" / "configs" / name).read_bytes()


def _strip_ts(records):
    return [{k: v for k, v in r.items() if k != "ts"} for r in records]


def test_manifest_writes_the_jax_packages_records(tmp_path):
    lines = {}
    for pkg, mod in (("jax", jmanifest), ("torch", tmanifest)):
        path = tmp_path / f"{pkg}.jsonl"
        m = mod.Manifest(path)
        m.mark_done("esm/A", n=3, seconds=1.5)
        m.mark_failed("esm/B", "boom", phase="score")
        again = mod.Manifest(path)  # reloads the done-markers
        assert again.is_done("esm/A") and not again.is_done("esm/B")
        assert again.pending(["esm/A", "esm/B", "esm/C"]) == ["esm/B", "esm/C"]
        lines[pkg] = _strip_ts(json.loads(x) for x in path.read_text().splitlines())
    assert lines["torch"] == lines["jax"]


def test_event_log_writes_the_jax_packages_records(tmp_path):
    lines = {}
    for pkg, mod in (("jax", jtelemetry), ("torch", ttelemetry)):
        path = tmp_path / f"{pkg}.jsonl"
        log = mod.EventLog(path)
        log.emit("throughput", label="packed/3", mutants_per_sec=12.5, path=Path("x"))
        with log.phase("score", model="esm"):
            pass
        with pytest.raises(ValueError), log.phase("merge"):
            raise ValueError("bad")
        recs = [json.loads(x) for x in path.read_text().splitlines()]
        for r in recs:  # wall-clock fields differ between the two runs
            r.pop("seconds", None)
        lines[pkg] = _strip_ts(recs)
    assert lines["torch"] == lines["jax"]
    assert [r["event"] for r in lines["torch"]] == [
        "throughput", "phase_start", "phase_end", "phase_start", "phase_error"]
