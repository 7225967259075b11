"""The port's downloader (proteingym_tpu_torch.data.download and the CLI's
``download``) offline: local ``file://`` URLs and archives already in the
cache, never the network. Its resource table equals the JAX package's
(tests/test_torch_shared_copies.py)."""

import hashlib
import zipfile

import pytest

from proteingym_tpu_torch.data import download as dl
from proteingym_tpu_torch.pipeline import cli


def test_resource_table_complete():
    names = {r[0] for r in dl.RESOURCES}
    assert len(dl.RESOURCES) == 22  # the published manifest's rows
    assert "DMS_ProteinGym_substitutions" in names
    assert all(len(r[2]) == 64 for r in dl.RESOURCES)  # sha256 hex


def test_fetch_file_verifies_hash(tmp_path):
    src = tmp_path / "blob.bin"
    src.write_bytes(b"hello proteingym")
    good = hashlib.sha256(b"hello proteingym").hexdigest()
    out = dl.fetch_file(src.as_uri(), tmp_path / "out.bin", expected_sha256=good)
    assert out.read_bytes() == b"hello proteingym"
    with pytest.raises(ValueError, match="SHA256 mismatch"):
        dl.fetch_file(src.as_uri(), tmp_path / "out2.bin", expected_sha256="0" * 64)
    assert not (tmp_path / "out2.bin").exists() and not (tmp_path / "out2.bin.part").exists()


def test_fetch_skips_existing_valid(tmp_path):
    dest = tmp_path / "cached.bin"
    dest.write_bytes(b"x" * 100)
    sha = hashlib.sha256(b"x" * 100).hexdigest()
    assert dl.fetch_file("file:///nonexistent", dest, expected_sha256=sha) == dest


def _archive(path):
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("sub/a.csv", "x,y\n1,2\n")
        z.writestr("b.txt", "hi")
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_unzip(tmp_path):
    archive = tmp_path / "z.zip"
    _archive(archive)
    files = dl.unzip(archive, tmp_path / "out")
    assert len(files) == 2
    assert (tmp_path / "out/sub/a.csv").read_text().startswith("x,y")


def test_download_resources_from_the_cache(tmp_path, monkeypatch):
    # an archive placed in the cache with the table's hash is verified and
    # unzipped without the network; a second call finds the extraction done
    cache = tmp_path / "cache"
    cache.mkdir()
    sha = _archive(cache / "fake.zip")
    monkeypatch.setattr(dl, "RESOURCES", [("fake", "fake.zip", sha, False)])
    monkeypatch.setattr(dl, "BASE_URL", "file:///nonexistent/{version}/{filename}")
    out = dl.download_resources(cache=cache, remove_zip=False)
    assert sorted(out["fake"]) == sorted([str(cache / "fake" / "sub" / "a.csv"),
                                          str(cache / "fake" / "b.txt")])
    assert (cache / "fake" / ".pgym_complete").exists() and (cache / "fake.zip").exists()
    again = dl.download_resources(cache=cache)
    assert sorted(again["fake"]) == sorted(out["fake"])


def test_download_resources_unknown_name(tmp_path):
    with pytest.raises(KeyError):
        dl.download_resources(names=["nope"], cache=tmp_path)


def test_cli_download(tmp_path, monkeypatch, capsys):
    assert cli.main(["download", "--list"]) == 0
    listed = capsys.readouterr().out.splitlines()
    assert len(listed) == len(dl.RESOURCES) and listed[0].startswith(dl.RESOURCES[0][0])
    src = tmp_path / "mirror"
    src.mkdir()
    sha = _archive(src / "fake.zip")
    monkeypatch.setattr(dl, "RESOURCES", [("fake", "fake.zip", sha, False)])
    monkeypatch.setattr(dl, "BASE_URL", src.as_uri() + "/{filename}")
    cache = tmp_path / "cache"
    assert cli.main(["download", "--resources", "fake", "--cache", str(cache)]) == 0
    assert capsys.readouterr().out.strip() == "fake: 2 file(s)"
    assert (cache / "fake" / "b.txt").read_text() == "hi"
    assert not (cache / "fake.zip").exists()  # removed unless --keep-zip
    assert cli.main(["download", "--resources", "fake", "--cache", str(cache), "--force",
                     "--keep-zip"]) == 0
    assert (cache / "fake.zip").exists()
