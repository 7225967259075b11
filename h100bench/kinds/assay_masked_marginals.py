"""Traffic of ``score`` one assay at a time: each call hands the port's
``esm_scoring.score_assay`` one assay (``strategy="masked-marginals"``),
cycling through a ladder of lengths; a call's time is the assay's latency.

Parameters (``traffic/<mix>.json``): ``lengths`` (the ladder, one assay a
call), ``doubles_per_residue``, ``chunk``, ``pool`` (ladder cycles drawn
from the seed, then repeated), ``profile`` and ``check`` as for
``packed_masked_marginals``.
"""

from __future__ import annotations

from h100bench import masked
from h100bench.masked import answer, mutant_count, needed, reference_answers, sample  # noqa: F401


def make_pool(traffic: dict, cfg: dict, seed: int):
    return masked.make_pool(traffic, seed, assays_per_call=1)


def call(program, forward, payload, traffic: dict, cfg: dict, device):
    from proteingym_tpu_torch.models import esm_scoring

    (seq, mutants), = payload
    scores = [esm_scoring.score_assay(forward, seq, mutants, strategy="masked-marginals",
                                      chunk=int(traffic["chunk"]), window=program.window,
                                      device=device)]
    masked.check_scores(payload, scores)
    return scores


def cycle_calls(traffic: dict) -> int:
    """Calls in one cycle of the ladder: a window holds whole cycles."""
    return len(traffic["lengths"])


def shapes(traffic: dict, cfg: dict):
    """``chunk`` rows of each length bucket (``score_assay``'s default
    multiples of 64, at most the window)."""
    window, chunk = cfg["max_positions"], int(traffic["chunk"])
    return sorted({(chunk, min(-(-(n + 2) // 64) * 64, window)) for n in traffic["lengths"]})


def warm_up_payload(traffic: dict, cfg: dict):
    seq, muts = masked.synth.assay(30, 2, 0)
    return [(seq, muts[:8] + muts[-2:])]
