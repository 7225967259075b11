"""Traffic of the autoregressive zoo's scorer: each call hands the port's
``ar_scoring.score_mutants_ar`` one request of mutants of one assay, as
``scorers._score_zoo`` runs it (absolute mode, ``target_seq=None``: every
mutated sequence scored whole, left to right and mirrored), under TF32
off. A request is one whole assay; requests cycle through a ladder of
assay lengths.

Parameters (``traffic/<mix>.json``): ``lengths`` (one assay per length,
drawn from the seed), ``doubles_per_residue`` (an assay holds every single
substitution and that many doubles per residue), ``batch`` (the scorer's
batch size), ``pool`` (ladder cycles of assays drawn from the seed, then
repeated), ``profile`` and ``check`` (``per_length`` sampled mutants).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from h100bench import protocols, synth


def make_pool(traffic: dict, cfg: dict, seed: int):
    """``pool`` cycles of one request per ladder length: an assay of that
    length drawn anew from the seed, all its singles and its doubles, with
    their mutated sequences."""
    pool = []
    for c in range(int(traffic["pool"])):
        for i, n in enumerate(traffic["lengths"]):
            seq, singles = synth.assay(n, 0, synth.seed_of(seed, 10, c, i))
            picked = singles + synth.doubles(seq, _doubles(traffic, n),
                                             synth.seed_of(seed, 12, c, i))
            pool.append({"seq": seq, "mutants": picked,
                         "mutated": [protocols.apply_mutant(seq, m) for m in picked]})
    return pool


def _doubles(traffic: dict, n: int) -> int:
    return int(round(traffic["doubles_per_residue"] * n))


def mutant_count(payload) -> int:
    return len(payload["mutants"])


def call(program, forward, payload, traffic: dict, cfg: dict, device):
    from proteingym_tpu_torch.devices import no_tf32
    from proteingym_tpu_torch.models import ar_scoring

    with no_tf32():
        table = ar_scoring.score_mutants_ar(
            forward, program.tokenize, pad_id=program.pad_id, mutants=payload["mutants"],
            mutated_sequences=payload["mutated"], target_seq=None,
            model_context_len=program.n_ctx, batch_size=int(traffic["batch"]), device=device)
    row = {s: i for i, s in enumerate(table["mutated_sequence"])}
    missing = [s for s in payload["mutated"] if s not in row]
    if missing:
        raise RuntimeError(f"{len(missing)} mutated sequences have no score")
    at = np.asarray([row[s] for s in payload["mutated"]])
    return (np.asarray(table["avg_score_L_to_R"], dtype=np.float64)[at],
            np.asarray(table["avg_score_R_to_L"], dtype=np.float64)[at])


def cycle_calls(traffic: dict) -> int:
    """Calls in one cycle of the ladder: a window holds whole cycles."""
    return len(traffic["lengths"])


def shapes(traffic: dict, cfg: dict):
    """The forwards a request makes: ``batch`` rows of each length bucket
    (multiples of 32), and the last, partial batch of a request."""
    batch, out = int(traffic["batch"]), set()
    for n in traffic["lengths"]:
        bucket = -(-n // 32) * 32
        out.add((batch, bucket))
        last = (19 * n + _doubles(traffic, n)) % batch
        if last:
            out.add((last, bucket))
    return sorted(out)


def warm_up_payload(traffic: dict, cfg: dict):
    seq, singles = synth.assay(30, 0, 0)
    return {"seq": seq, "mutants": singles[:4],
            "mutated": [protocols.apply_mutant(seq, m) for m in singles[:4]]}


def needed(payload, cfg: dict, family):
    """(tokens, operations) that the protocol needs: two forwards (L->R and
    R->L) of L tokens per mutated sequence."""
    n = len(payload["seq"])
    rows = 2 * len(set(payload["mutated"]))
    return float(rows * n), rows * family.forward_flops(cfg, n)


def sample(records, pool, traffic: dict, seed: int):
    """For each length, ``check['per_length']`` mutants of the requests of
    that length that the window scored, half singles and half doubles.
    Items are (payload, mutant) indices."""
    rs = np.random.RandomState(synth.seed_of(seed, 3))
    scored = sorted({r["payload"] for r in records if r.get("answers") is not None})
    per = int(traffic["check"]["per_length"])
    items = []
    for length in sorted(set(traffic["lengths"])):
        places = [p for p in scored if len(pool[p]["seq"]) == length]
        if not places:
            continue
        for k in range(per):
            p = places[rs.randint(len(places))]
            muts = pool[p]["mutants"]
            idx = [i for i, m in enumerate(muts) if (":" in m) == (k % 2 == 1)] or list(range(len(muts)))
            items.append((p, idx[rs.randint(len(idx))]))
    return sorted(set(items))


def answer(answers, payload, item) -> tuple:
    _, m = item
    return float(answers[0][m]), float(answers[1][m])


def reference_answers(items, pool, cfg: dict, family, reference, device) -> Dict[tuple, tuple]:
    """{item: (L->R, R->L)}: the mirrored scores worked out by the
    reference from the mutated sequences."""
    seqs = [pool[p]["mutated"][m] for p, m in items]
    l2r, r2l = protocols.ar_mirrored_scores(reference.loglik, family.tokenize, seqs,
                                            cfg["n_ctx"])
    return {it: (float(a), float(b)) for it, a, b in zip(items, l2r, r2l)}
