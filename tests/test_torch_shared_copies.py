"""The port's own copies of what it needs from the JAX package, held equal
to their originals: the constants by value, the packaged registry JSON by
bytes, and the manifest and event-log records as each package writes them.
The port imports none of the originals (tests/test_torch_no_jax.py)."""

import json
from pathlib import Path

import pytest

from proteingym_tpu import constants as jconst
from proteingym_tpu.data import download as jdownload
from proteingym_tpu.pipeline import manifest as jmanifest
from proteingym_tpu.pipeline import telemetry as jtelemetry
from proteingym_tpu_torch import constants as tconst
from proteingym_tpu_torch.data import download as tdownload
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


def test_structure_vocabularies_equal_the_jax_packages():
    # the token tables the structure scorers copied: ESM-IF1's alphabet,
    # ProteinMPNN's, the 3Di letters and SaProt's residue letters
    from proteingym_tpu.models import gvp_transformer as jg
    from proteingym_tpu.models import protein_mpnn as jm
    from proteingym_tpu.models import saprot as js
    from proteingym_tpu.ops import tridi as jt
    from proteingym_tpu_torch.models import gvp_transformer as tg
    from proteingym_tpu_torch.models import protein_mpnn as tm
    from proteingym_tpu_torch.models import saprot as ts
    from proteingym_tpu_torch.ops import tridi as tt

    assert tg.IF1_TOKENS == jg.IF1_TOKENS
    assert (tg.PAD_IDX, tg.MASK_IDX, tg.CATH_IDX, tg.VOCAB) == (jg.PAD_IDX, jg.MASK_IDX,
                                                              jg.CATH_IDX, jg.VOCAB)
    assert tm.MPNN_ALPHABET == jm.MPNN_ALPHABET
    assert tt.TRIDI_VOCAB == jt.TRIDI_VOCAB
    assert (ts.SEQ_CHARS, ts.STRUC_CHARS, ts.BLOCK) == (js.SEQ_CHARS, js.STRUC_CHARS, js.BLOCK)


def test_supervised_track_copies_equal_the_jax_packages():
    # the tables the VESPA family and the supervised track copied: ProtT5's
    # reconstructed token ids, VESPA's blend and BLOSUM block, the CV
    # schemes, the evaluation's category names and Kermut's initial values
    import numpy as np

    from proteingym_tpu.merge import supervised as jms
    from proteingym_tpu.metrics import supervised as jmet
    from proteingym_tpu.models import kermut as jk
    from proteingym_tpu.models import prot_t5 as jt5
    from proteingym_tpu.models import supervised_baselines as jsb
    from proteingym_tpu.models import vespa_heads as jvh
    from proteingym_tpu_torch.merge import supervised as tms
    from proteingym_tpu_torch.metrics import supervised as tmet
    from proteingym_tpu_torch.models import kermut as tk
    from proteingym_tpu_torch.models import prot_t5 as tt5
    from proteingym_tpu_torch.models import supervised_baselines as tsb
    from proteingym_tpu_torch.models import vespa_heads as tvh

    assert tt5.AA_TOKEN_IDS == jt5.AA_TOKEN_IDS
    assert (tt5.PAD_ID, tt5.EOS_ID, tt5.UNK_ID) == (jt5.PAD_ID, jt5.EOS_ID, jt5.UNK_ID)
    for name in ("prot_t5_xl", "prot_t5_tiny"):
        t, j = tt5.PRESETS[name], jt5.PRESETS[name]
        assert all(getattr(t, f) == getattr(j, f) for f in ("vocab_size", "d_model", "d_kv",
                   "num_heads", "num_layers", "d_ff", "num_buckets", "max_distance", "gated"))
    np.testing.assert_array_equal(tvh.DEFAULT_BLEND["w"], jvh.DEFAULT_BLEND["w"])
    assert tvh.DEFAULT_BLEND["b"] == jvh.DEFAULT_BLEND["b"]
    np.testing.assert_array_equal(tvh._blosum20(), jvh._blosum20())
    assert (tms.CV_SCHEMES_SUBS, tms.CV_SCHEMES_INDELS) == (jms.CV_SCHEMES_SUBS,
                                                            jms.CV_SCHEMES_INDELS)
    assert tsb.CV_SCHEMES == jsb.CV_SCHEMES
    assert (tmet.METRICS, tmet.TAXON_COLUMNS, tmet.DEPTH_COLUMNS, tmet.FUNCTION_CATEGORIES) == (
        jmet.METRICS, jmet.TAXON_COLUMNS, jmet.DEPTH_COLUMNS, jmet.FUNCTION_CATEGORIES)
    assert {k: float(v) for k, v in jk.init_hypers().items()} == tk.HYPER_INIT


@pytest.mark.parametrize("name", ["RESOURCES", "PROTEINGYM_VERSION", "BASE_URL"])
def test_download_table_equals_the_jax_packages(name):
    assert getattr(tdownload, name) == getattr(jdownload, name)
