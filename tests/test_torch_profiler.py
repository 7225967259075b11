"""The port's profiler (pipeline/profiler.py) and ``score --profile-dir`` on
the CPU: the trace is the Chrome trace TensorBoard's profiler plugin reads
and names the scoring's operators; ``Throughput`` writes the JAX package's
records; the CLI's throughput events stay as they were."""

import json

import numpy as np
import torch

from proteingym_tpu.pipeline import profiler as jprofiler
from proteingym_tpu_torch.pipeline import cli, profiler
from proteingym_tpu_torch.pipeline.telemetry import EventLog


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiler.trace(str(tmp_path / "tb")):
        torch.matmul(torch.ones(32, 32), torch.ones(32, 32)).sum()
    files = list((tmp_path / "tb").glob("*.pt.trace.json"))
    assert len(files) == 1
    trace = json.loads(files[0].read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::matmul" in names


def test_throughput_records_equal_jax(tmp_path):
    records = {}
    for name, mod in (("jax", jprofiler), ("torch", profiler)):
        log = EventLog(tmp_path / f"{name}.jsonl")
        t = mod.Throughput(event_log=log)
        with t.measure(10, label="esm/A"):
            pass
        with t.measure(5, label="esm/B"):
            pass
        records[name] = [{k for k in json.loads(x)} for x in
                         (tmp_path / f"{name}.jsonl").read_text().splitlines()]
        assert t.total_mutants == 15 and set(t.summary()) == {
            "total_mutants", "total_seconds", "mutants_per_sec"}
    assert records["jax"] == records["torch"]
    assert profiler.device_memory_stats() == {} or torch.cuda.is_available()


def _world(root):
    seq = "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEV"
    muts = [f"{seq[p]}{p + 1}A" for p in range(1, 12) if seq[p] != "A"]
    (root / "dms").mkdir()
    (root / "ref.csv").write_text(f"DMS_id,DMS_filename,target_seq\nP1,P1.csv,{seq}\n")
    (root / "dms" / "P1.csv").write_text("mutant\n" + "\n".join(muts) + "\n")
    return muts


def test_score_profile_dir(tmp_path):
    muts = _world(tmp_path)
    args = ["score", "--model", "esm", "--checkpoint", "esm2_tiny", "--device", "cpu",
            "--dms-reference", str(tmp_path / "ref.csv"), "--dms-dir", str(tmp_path / "dms"),
            "--quiet"]
    assert cli.main(args + ["--output-dir", str(tmp_path / "plain")]) == 0
    assert cli.main(args + ["--output-dir", str(tmp_path / "out"),
                            "--profile-dir", str(tmp_path / "tb")]) == 0
    files = list((tmp_path / "tb").glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "aten::linear" in names
    a = (tmp_path / "plain" / "P1.csv").read_text()
    assert a == (tmp_path / "out" / "P1.csv").read_text() and len(a.splitlines()) == len(muts) + 1
    events = [json.loads(x) for x in (tmp_path / "out" / "events.jsonl").read_text().splitlines()]
    kinds = [e["event"] for e in events]
    assert kinds == ["phase_start", "throughput", "phase_end", "throughput_summary"]
    tp = events[1]
    assert tp["label"] == "esm/P1" and tp["n_mutants"] == len(muts)
    assert np.isclose(tp["mutants_per_sec"], len(muts) / max(tp["seconds"], 1e-9), rtol=0.05)
