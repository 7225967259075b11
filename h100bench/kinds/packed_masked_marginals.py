"""Traffic of ``score --packed``: each call hands the port's
``packed_scoring.score_assays_packed`` a whole ladder of assays, which it
scores in shared cross-assay forwards of ``chunk`` masked rows.

Parameters (``traffic/<mix>.json``): ``lengths`` (the ladder, one call),
``doubles_per_residue``, ``chunk``, ``pool`` (distinct calls drawn from the
seed, then repeated), ``profile`` (``skip`` and ``calls`` of the traced
part) and ``check`` (``per_length`` sampled mutants).
"""

from __future__ import annotations

from h100bench import masked
from h100bench.masked import answer, mutant_count, needed, reference_answers, sample  # noqa: F401


def make_pool(traffic: dict, cfg: dict, seed: int):
    return masked.make_pool(traffic, seed, assays_per_call=len(traffic["lengths"]))


def call(program, forward, payload, traffic: dict, cfg: dict, device):
    from proteingym_tpu_torch.models import packed_scoring

    scores = packed_scoring.score_assays_packed(
        forward, payload, chunk=int(traffic["chunk"]), window=program.window, device=device)
    masked.check_scores(payload, scores)
    return scores


def cycle_calls(traffic: dict) -> int:
    """Calls in one cycle of the ladder: a window holds whole cycles."""
    return 1  # each call is the whole ladder


def shapes(traffic: dict, cfg: dict):
    """The (rows, tokens) of the forwards that a call makes: ``chunk`` rows
    of each length bucket (multiples of 32, at most the window)."""
    window, chunk = cfg["max_positions"], int(traffic["chunk"])
    return sorted({(chunk, min(-(-(n + 2) // 32) * 32, window)) for n in traffic["lengths"]})


def warm_up_payload(traffic: dict, cfg: dict):
    """A small call through the same entry: one short assay, a few mutants."""
    seq, muts = masked.synth.assay(30, 2, 0)
    return [(seq, muts[:8] + muts[-2:])]
