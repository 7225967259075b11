"""Backbone structures from PDB files (counterpart of
proteingym_tpu/data/structures.py, in numpy): the (L, 4, 3) N/CA/C/O
coordinates that ESCOTT's and RSALOR's burial proxy reads, the per-residue
CA B-factors (pLDDT in AlphaFold files) that S3F's fallback reads, an
idealised helix for tests and smoke runs, and a writer of such a backbone
as PDB ATOM records.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

BACKBONE_ATOMS = ("N", "CA", "C", "O")
THREE_TO_ONE = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "CYS": "C",
    "GLN": "Q", "GLU": "E", "GLY": "G", "HIS": "H", "ILE": "I",
    "LEU": "L", "LYS": "K", "MET": "M", "PHE": "F", "PRO": "P",
    "SER": "S", "THR": "T", "TRP": "W", "TYR": "Y", "VAL": "V",
    "MSE": "M", "SEC": "U", "PYL": "O",
}


def _backbone_residues(path, chain: Optional[str]) -> Tuple[list, str, np.ndarray]:
    """The residues with a complete backbone, in file order: their (4, 3)
    N/CA/C/O coordinates, one-letter sequence and (L,) float32 CA
    B-factors (a field that does not parse reads 0). Only the first model
    (up to ``ENDMDL``), altlocs blank or ``A``, and (by default) the first
    chain encountered are read."""
    residues: Dict[tuple, Dict[str, np.ndarray]] = {}
    res_names: Dict[tuple, str] = {}
    bfactors: Dict[tuple, float] = {}
    picked_chain = chain
    with open(path) as f:
        for line in f:
            if line.startswith("ENDMDL"):
                break
            if not line.startswith("ATOM"):
                continue
            atom = line[12:16].strip()
            if atom not in BACKBONE_ATOMS:
                continue
            ch = line[21]
            if picked_chain is None:
                picked_chain = ch
            if ch != picked_chain:
                continue
            if line[16] not in (" ", "A"):
                continue
            key = (ch, line[22:27])  # resseq + icode
            xyz = np.array([float(line[30:38]), float(line[38:46]), float(line[46:54])])
            residues.setdefault(key, {})[atom] = xyz
            res_names[key] = line[17:20].strip()
            if atom == "CA":
                try:
                    bfactors[key] = float(line[60:66])
                except ValueError:
                    bfactors[key] = 0.0

    keep = [key for key, atoms in residues.items() if all(a in atoms for a in BACKBONE_ATOMS)]
    coords = [np.stack([residues[key][a] for a in BACKBONE_ATOMS]) for key in keep]
    seq = "".join(THREE_TO_ONE.get(res_names[key], "X") for key in keep)
    return coords, seq, np.asarray([bfactors[key] for key in keep], np.float32)


def parse_pdb_backbone(path, chain: Optional[str] = None) -> Tuple[np.ndarray, str]:
    """Parse ATOM records -> ((L, 4, 3) coords, one-letter sequence) of the
    residues with a complete backbone (``_backbone_residues``); raises
    without one."""
    coords, seq, _ = _backbone_residues(path, chain)
    if not coords:
        raise ValueError(f"No complete backbone residues in {path}")
    return np.stack(coords), seq


def parse_pdb_bfactors(path, chain: Optional[str] = None) -> np.ndarray:
    """(L,) float32 CA B-factors of the residues ``parse_pdb_backbone``
    keeps; a CA field that does not parse reads 0."""
    return _backbone_residues(path, chain)[2]


def synthetic_helix_backbone(sequence_len: int, seed: int = 0) -> np.ndarray:
    """Idealised alpha-helix backbone (rise 1.5 A and 100 degrees a residue,
    radius 2.3 A), with 0.01 A of seeded noise on N, C and O."""
    rs = np.random.RandomState(seed)
    t = np.arange(sequence_len)
    theta = np.deg2rad(100.0) * t
    ca = np.stack([2.3 * np.cos(theta), 2.3 * np.sin(theta), 1.5 * t], axis=-1)
    n = ca + np.array([-0.5, 0.8, -0.9]) + 0.01 * rs.randn(sequence_len, 3)
    c = ca + np.array([0.7, 0.6, 0.9]) + 0.01 * rs.randn(sequence_len, 3)
    o = c + np.array([0.6, -1.0, 0.2]) + 0.01 * rs.randn(sequence_len, 3)
    return np.stack([n, ca, c, o], axis=1)


def write_pdb_backbone(path, coords: np.ndarray, sequence: str, chain: str = "A",
                       bfactors: Optional[np.ndarray] = None) -> None:
    """Write (L, 4, 3) backbone coordinates as PDB ATOM records (residues
    numbered from 1, coordinates to 3 decimals), which
    ``parse_pdb_backbone`` reads back; every atom of residue i carries
    ``bfactors[i]`` (2 decimals), 0 without them."""
    one_to_three = {v: k for k, v in THREE_TO_ONE.items() if k not in ("MSE",)}
    lines, serial = [], 1
    for i, (res, aa) in enumerate(zip(coords, sequence)):
        b = 0.0 if bfactors is None else float(bfactors[i])
        for atom, (x, y, z) in zip(BACKBONE_ATOMS, res):
            lines.append(f"ATOM  {serial:5d} {atom:^4s} {one_to_three.get(aa, 'UNK')} "
                         f"{chain}{i + 1:4d}    {x:8.3f}{y:8.3f}{z:8.3f}  1.00{b:6.2f}"
                         f"           {atom[0]}")
            serial += 1
    Path(path).write_text("\n".join(lines) + "\nEND\n")
