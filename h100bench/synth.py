"""Seeded synthetic assays: a random wild type over the 20 amino acids,
every single substitution, and doubles drawn from the seed."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

AA = "ACDEFGHIKLMNPQRSTVWY"


def seed_of(*parts: int) -> int:
    """A 32-bit seed for ``np.random.RandomState`` from any whole numbers
    (a run's seed may exceed 32 bits)."""
    return int(np.random.SeedSequence([abs(int(p)) for p in parts]
                                      + [int(p < 0) for p in parts]).generate_state(1)[0])


def synth_assay(seq_len: int, seed: int):
    """A wild type of ``seq_len`` residues and all its single mutants.
    Copied from ``chip_smoke.synth_assay``."""
    rs = np.random.RandomState(seed)
    seq = "".join(AA[i] for i in rs.randint(0, 20, seq_len))
    mutants = [f"{seq[p]}{p + 1}{m}" for p in range(seq_len) for m in AA
               if m != seq[p]]
    return seq, mutants


def doubles(seq: str, count: int, seed: int) -> List[str]:
    """``count`` distinct double mutants of ``seq``: two distinct positions
    in increasing order, each to another amino acid."""
    rs = np.random.RandomState(seed)
    out, seen = [], set()
    while len(out) < count:
        p, q = sorted(rs.choice(len(seq), 2, replace=False).tolist())
        a = AA[rs.randint(20)]
        b = AA[rs.randint(20)]
        if a == seq[p] or b == seq[q]:
            continue
        m = f"{seq[p]}{p + 1}{a}:{seq[q]}{q + 1}{b}"
        if m not in seen:
            seen.add(m)
            out.append(m)
    return out


def assay(seq_len: int, n_doubles: int, seed: int) -> Tuple[str, List[str]]:
    """A synthetic assay: every single and ``n_doubles`` doubles."""
    seq, singles = synth_assay(seq_len, seed)
    return seq, singles + doubles(seq, n_doubles, seed_of(seed, 1))
