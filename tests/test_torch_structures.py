"""The port's PDB backbone parser and synthetic helix
(proteingym_tpu_torch.data.structures) against the JAX package's, on
files with altlocs, a residue missing a backbone atom, insertion codes,
two chains, HETATM records and a second model after ENDMDL; and the
port's PDB writer read back by both parsers."""

import numpy as np
import pytest

from proteingym_tpu.data import structures as jstruct
from proteingym_tpu_torch.data import structures as tstruct


def _atom(serial, name, res, chain, num, xyz, altloc=" ", icode=" ", record="ATOM  "):
    x, y, z = xyz
    return (f"{record}{serial:5d} {name:^4s}{altloc}{res} {chain}{num:4d}{icode}   "
            f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00 20.00           {name[0]}")


def _awkward_pdb(path):
    rs = np.random.RandomState(0)
    lines, serial = ["HEADER    TEST"], 1

    def residue(res, chain, num, atoms=("N", "CA", "C", "O", "CB"), **kw):
        nonlocal serial
        for name in atoms:
            lines.append(_atom(serial, name, res, chain, num, rs.randn(3) * 10, **kw))
            serial += 1

    residue("MET", "B", 1)  # the first chain seen is B
    residue("ALA", "B", 2)
    for altloc in "AB":  # altloc A is read, B is skipped
        residue("SER", "B", 3, altloc=altloc)
    residue("GLY", "B", 4, atoms=("N", "CA", "O"))  # no C: dropped
    residue("LYS", "B", 5)
    residue("LYS", "B", 5, icode="A")  # an insertion code is its own residue
    lines.append(_atom(serial, "CA", "HOH", "B", 6, (1, 2, 3), record="HETATM"))
    residue("MSE", "B", 7)
    residue("XYZ", "B", 8)  # unknown: X
    residue("TRP", "A", 1)  # another chain
    lines.append("ENDMDL")
    residue("TYR", "B", 9)  # a second model
    path.write_text("\n".join(lines) + "\nEND\n")


@pytest.mark.parametrize("chain", [None, "A", "B"])
def test_parse_pdb_backbone_equals_jax(tmp_path, chain):
    path = tmp_path / "awkward.pdb"
    _awkward_pdb(path)
    coords, seq = tstruct.parse_pdb_backbone(path, chain=chain)
    want_coords, want_seq = jstruct.parse_pdb_backbone(path, chain=chain)
    assert seq == want_seq
    np.testing.assert_array_equal(coords, want_coords)
    assert coords.shape == (len(seq), 4, 3)
    if chain in (None, "B"):
        assert seq == "MASKKMX"
    else:
        assert seq == "W"


def test_no_backbone_raises(tmp_path):
    path = tmp_path / "empty.pdb"
    path.write_text(_atom(1, "CB", "ALA", "A", 1, (0, 0, 0)) + "\n")
    with pytest.raises(ValueError, match="No complete backbone"):
        tstruct.parse_pdb_backbone(path)
    with pytest.raises(ValueError, match="No complete backbone"):
        jstruct.parse_pdb_backbone(path)


@pytest.mark.parametrize("n,seed", [(1, 0), (44, 3), (250, 0)])
def test_synthetic_helix_equals_jax(n, seed):
    np.testing.assert_array_equal(tstruct.synthetic_helix_backbone(n, seed=seed),
                                  jstruct.synthetic_helix_backbone(n, seed=seed))


def test_written_backbone_reads_back(tmp_path):
    coords = tstruct.synthetic_helix_backbone(60, seed=2)
    seq = "ACDEFGHIKLMNPQRSTVWY" * 3
    tstruct.write_pdb_backbone(tmp_path / "x.pdb", coords, seq)
    for parse in (tstruct.parse_pdb_backbone, jstruct.parse_pdb_backbone):
        got, got_seq = parse(tmp_path / "x.pdb")
        assert got_seq == seq
        np.testing.assert_allclose(got, coords, atol=5e-4, rtol=0)  # 3 decimals


def _with_bfactors(path):
    """The awkward PDB with every atom's B-factor its own seeded number, and
    one CA whose field does not parse (read as 0)."""
    rs = np.random.RandomState(5)
    lines = []
    for i, line in enumerate(path.read_text().splitlines()):
        if line.startswith(("ATOM", "HETATM")):
            field = "  x.yz" if i == 7 else f"{rs.uniform(20, 99):6.2f}"
            line = line[:60] + field + line[66:]
        lines.append(line)
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("chain", [None, "A", "B"])
def test_parse_pdb_bfactors_equals_jax(tmp_path, chain):
    path = tmp_path / "awkward.pdb"
    _awkward_pdb(path)
    _with_bfactors(path)
    got = tstruct.parse_pdb_bfactors(path, chain=chain)
    want = jstruct.parse_pdb_bfactors(path, chain=chain)
    assert got.dtype == np.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # one B-factor per residue that parse_pdb_backbone keeps
    assert len(got) == len(tstruct.parse_pdb_backbone(path, chain=chain)[1])
    if chain in (None, "B"):
        assert (got == 0).sum() == 1 and (got[got != 0] >= 20).all()


def test_written_bfactors_read_back(tmp_path):
    coords = tstruct.synthetic_helix_backbone(30, seed=4)
    seq = "ACDEFGHIKLMNPQRSTVWY"[:15] * 2
    plddt = np.where(np.arange(30) % 7 < 3, 50.0, 90.0) + np.arange(30) * 0.013
    tstruct.write_pdb_backbone(tmp_path / "b.pdb", coords, seq, bfactors=plddt)
    for parse in (tstruct.parse_pdb_bfactors, jstruct.parse_pdb_bfactors):
        # 2 decimals, then float32
        np.testing.assert_allclose(parse(tmp_path / "b.pdb"), plddt, atol=5.1e-3, rtol=0)
    tstruct.write_pdb_backbone(tmp_path / "z.pdb", coords, seq)  # no B-factors: 0
    assert not jstruct.parse_pdb_bfactors(tmp_path / "z.pdb").any()
    assert tstruct.parse_pdb_backbone(tmp_path / "b.pdb")[1] == seq
