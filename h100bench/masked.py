"""What the two masked-marginal kinds share: assays from the seed, the
protocol's work, the sample that is checked and its reference scores.

A payload is a list of assays ``(wild type, mutants)``; a call's answers
are one score array per assay, aligned with its mutants.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from h100bench import protocols, synth


def make_pool(traffic: dict, seed: int, assays_per_call: int) -> List[list]:
    """``traffic['pool']`` payloads: the ladder of lengths cut into calls of
    ``assays_per_call`` assays, each assay drawn anew from the seed, with
    ``traffic['doubles_per_residue']`` x L doubles."""
    ladder = list(traffic["lengths"])
    pool = []
    for c in range(int(traffic["pool"])):
        for a0 in range(0, len(ladder), assays_per_call):
            pool.append([synth.assay(n, int(round(traffic["doubles_per_residue"] * n)),
                                     synth.seed_of(seed, c, a0 + j))
                         for j, n in enumerate(ladder[a0:a0 + assays_per_call])])
    return pool


def mutant_count(payload) -> int:
    return sum(len(m) for _, m in payload)


def needed(payload, cfg: dict, family) -> Tuple[float, float]:
    """(tokens, operations) that the protocol needs: L + 2 masked rows per
    assay, each one forward of min(L + 2, window) unpadded tokens."""
    window = cfg["max_positions"]
    tokens = flops = 0.0
    for seq, _ in payload:
        n = len(seq) + 2
        t = min(n, window)
        tokens += n * t
        flops += n * family.forward_flops(cfg, t)
    return tokens, flops


def sample(records, pool, traffic: dict, seed: int):
    """The checked sample, drawn from the seed: for each length of the
    ladder, ``traffic['check']['per_length']`` mutants of the assays of
    that length that the window scored, half singles and half doubles.
    Items are (payload, assay, mutant) indices."""
    rs = np.random.RandomState(synth.seed_of(seed, 3))
    scored = sorted({r["payload"] for r in records if r.get("answers") is not None})
    per = int(traffic["check"]["per_length"])
    items = []
    for length in sorted(set(traffic["lengths"])):
        places = [(p, a) for p in scored for a, (seq, _) in enumerate(pool[p])
                  if len(seq) == length]
        if not places:
            continue
        for k in range(per):
            p, a = places[rs.randint(len(places))]
            muts = pool[p][a][1]
            want_double = k % 2 == 1
            idx = [i for i, m in enumerate(muts) if (":" in m) == want_double] or list(range(len(muts)))
            items.append((p, a, idx[rs.randint(len(idx))]))
    return sorted(set(items))


def reference_scores(items, pool, reference, tokenize, mask_idx: int, index: Dict[str, int],
                     window: int, device) -> Dict[tuple, float]:
    """{item: the reference's score}: the masked rows of every site that the
    sampled mutants touch, worked out again here, and the sums."""
    by_assay: Dict[Tuple[int, int], List[int]] = {}
    for p, a, m in items:
        by_assay.setdefault((p, a), []).append(m)
    out = {}
    for (p, a), ms in by_assay.items():
        seq, muts = pool[p][a]
        sites = [pos for m in ms for _, pos, _ in protocols.parse_mutant(muts[m])]
        logprobs = protocols.masked_logprobs(reference.logits, tokenize(seq), sites,
                                             mask_idx, window, device)
        for m in ms:
            out[(p, a, m)] = protocols.masked_marginal_score(muts[m], logprobs, index)
    return out


def answer(answers, payload, item) -> tuple:
    """The program's answer to a sampled (payload, assay, mutant) item."""
    _, a, m = item
    return (float(answers[a][m]),)


def reference_answers(items, pool, cfg: dict, family, reference, device) -> Dict[tuple, tuple]:
    """{item: (the reference's score,)}."""
    scores = reference_scores(items, pool, reference, family.tokenize, family.MASK,
                              family.INDEX, cfg["max_positions"], device)
    return {k: (v,) for k, v in scores.items()}


def check_scores(payload, answers: Sequence[np.ndarray]) -> None:
    """Fail a call whose answers are not one finite score per mutant."""
    if len(answers) != len(payload):
        raise RuntimeError(f"{len(answers)} score arrays for {len(payload)} assays")
    for (_, muts), ans in zip(payload, answers):
        if np.shape(ans) != (len(muts),):
            raise RuntimeError(f"scores of shape {np.shape(ans)} for {len(muts)} mutants")
