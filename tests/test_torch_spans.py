"""The port's spans (``pipeline.profiler.span``) in the scoring harness and
the kernel entries: nothing recorded, and one shared no-op, without a
profiler; under one, each harness span counted as the harness runs it,
named in the profiler's own events, its self time within its total, never
around a model forward, and the scores bit for bit those of an unprofiled
run. The entries' launch spans need the card (marked ``cuda``)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from proteingym_tpu_torch.models import ar_scoring, ar_zoo, esm2, esm_scoring, packed_scoring
from proteingym_tpu_torch.ops import flash_attention as fa
from proteingym_tpu_torch.pipeline import profiler

CPU = torch.device("cpu")
AA = "ACDEFGHIKLMNPQRSTVWY"
FORWARD = "test.forward"
HARNESS = ("plan", "rows", "upload", "readback", "gather", "parse")


def _assay(length, seed):
    rng = np.random.default_rng(seed)
    wt = "".join(rng.choice(list(AA), length))
    muts = [f"{wt[p]}{p + 1}{AA[(AA.index(wt[p]) + 1 + p) % 20]}" for p in range(length)]
    return wt, muts + [f"{muts[0]}:{muts[2]}"]


class _Counted(torch.nn.Module):
    """The model, its forwards counted and each inside ``test.forward``."""

    def __init__(self, fn, module):
        super().__init__()
        self.fn, self.inner, self.calls = fn, module, 0

    def forward(self, *args):
        self.calls += 1
        with record_function(FORWARD):
            return self.fn(*args)


@pytest.fixture(scope="module")
def esm():
    return esm2.init_random(esm2.PRESETS["esm2_tiny"], seed=0, device=CPU)


@pytest.fixture(scope="module")
def progen():
    config = ar_zoo.ProGen2Config("tiny", 2, 64, 8, 4, mp_num=8, dtype=torch.float32)
    return ar_zoo.progen2_init(config, seed=0, device=CPU)


ASSAYS = [_assay(9, 1), _assay(20, 2), _assay(33, 3)]


def _score(kind, esm, progen):
    """(scores, {span: count expected}) of one harness call."""
    if kind.startswith("score_assay"):
        window = 16 if kind.endswith("windowed") else 1024
        model = _Counted(esm, esm)
        seq, muts = ASSAYS[2]
        out = esm_scoring.score_assay(model, seq, muts, chunk=8, window=window, device=CPU)
        return [out], model.calls, {"readback": 1, "rows": model.calls,
                                    "upload": model.calls, "parse": 1}
    if kind.startswith("packed"):
        model = _Counted(esm, esm)
        kw = dict(chunk=8, super_chunks=2, pad_to_multiple=16, device=CPU)
        segments = kind.endswith("segments")
        if segments:
            kw.update(apply_fn=None, seg_apply_fn=model, row_len=64, seg_chunk=2)
        else:
            kw.update(apply_fn=model)
        out = packed_scoring.score_assays_packed(assays=ASSAYS, **kw)
        groups = 1 if segments else len({-(-(len(s) + 2) // 16) for s, _ in ASSAYS})
        # segment rows are built on the device alone, with no upload
        return out, model.calls, {"readback": groups, "rows": model.calls,
                                  "upload": 0 if segments else model.calls,
                                  "parse": len(ASSAYS), "gather": groups}
    model = _Counted(progen.restricted_logits, progen)
    tok = {c: i for i, c in enumerate("ABCDEFGHIKLMNOPQRSTUVWXYZ")}
    seq, muts = ASSAYS[1]
    seqs = [seq[:int(m[1:-1]) - 1] + m[-1] + seq[int(m[1:-1]):] for m in muts[:-1]]
    table = ar_scoring.score_mutants_ar(
        model, lambda s: np.asarray([tok[c] for c in s], np.int64), pad_id=tok["X"],
        mutants=muts[:-1], mutated_sequences=seqs, target_seq=seq, model_context_len=12,
        batch_size=4, device=CPU)
    # one read-back a forward block; each direction gathers once, the join once
    return ([table["avg_score"]], model.calls,
            {"readback": model.calls, "rows": model.calls, "upload": model.calls,
             "gather": 3})


KINDS = ["score_assay", "score_assay_windowed", "packed", "packed_segments", "ar"]


@pytest.mark.parametrize("kind", KINDS)
def test_no_profiler_records_nothing(kind, esm, progen):
    profiler.clear_spans()
    assert profiler.span("a") is profiler.span("b")  # the one shared no-op
    _score(kind, esm, progen)
    assert profiler.span_totals() == {}


@pytest.mark.parametrize("kind", KINDS)
def test_profiled_harness_spans(kind, esm, progen):
    plain, _, _ = _score(kind, esm, progen)
    profiler.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got, forwards, expected = _score(kind, esm, progen)
    totals = profiler.span_totals()
    assert forwards > 0 and totals, totals
    for name, count in expected.items():
        assert totals.get(f"pgym.harness.{name}", (0,))[0] == count, (name, totals)
    assert totals["pgym.harness.plan"][0] >= 1
    assert set(totals) <= {f"pgym.harness.{n}" for n in HARNESS}
    for count, seconds, self_seconds in totals.values():
        assert count > 0 and 0 <= self_seconds <= seconds
    events = prof.events()
    assert set(totals) <= {e.name for e in events}
    spans = [e for e in events if e.name.startswith("pgym.harness.")]
    fwd = [e for e in events if e.name == FORWARD]
    assert len(fwd) == forwards
    for s in spans:  # no harness span holds a forward
        assert not any(s.time_range.start <= f.time_range.start
                       and f.time_range.end <= s.time_range.end for f in fwd), s.name
    for a, b in zip(plain, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_self_time_leaves_out_child_spans():
    profiler.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiler.span("outer"):
            with profiler.span("inner"):
                torch.ones(64, 64).sum()
            with profiler.span("inner"):
                pass
    totals = profiler.span_totals()
    n_out, out, out_self = totals["outer"]
    n_in, inner, inner_self = totals["inner"]
    assert (n_out, n_in) == (1, 2) and inner == inner_self
    assert out_self == pytest.approx(out - inner, abs=1e-9)
    profiler.clear_spans()
    assert profiler.span_totals() == {}


@pytest.mark.cuda
def test_launch_spans_count_the_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    q, k, v = (torch.randn(2, 64, 4, 64, device=dev, dtype=torch.bfloat16) for _ in range(3))
    mask = torch.arange(64, device=dev)[None] < torch.tensor([[64], [40]], device=dev)
    fa.grouped_mha_bthd(q, k, v, key_mask=mask, rope_base=10000.0)  # built, outside the trace
    profiler.clear_spans()
    before = dict(fa.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fa.grouped_mha_bthd(q, k, v, key_mask=mask, rope_base=10000.0)
        torch.cuda.synchronize(dev)
    name = "pgym.launch.grouped_attention_bthd"
    assert profiler.span_totals()[name][0] == (
        fa.LAUNCHES["grouped_attention_bthd"] - before["grouped_attention_bthd"]) == 3
    assert name in {e.name for e in prof.events()}
