"""Resource downloader: fetch + SHA256-verify + unzip the ProteinGym data
(the port's own copy of proteingym_tpu/data/download.py, behind the
``download`` subcommand).

Native replacement for the pooch-based reference downloader
(ref: proteingym/utils/download.py:59-251) using only the standard
library (urllib/hashlib/zipfile). The resource table (URLs + SHA256)
is the published ProteinGym v1.1 manifest embedded in the reference;
``tests/test_torch_shared_copies.py`` holds it equal to the JAX
package's. ``BASE_URL`` is the only remote address; ``fetch_file`` takes
any URL urllib opens, a local ``file://`` one included, so a mirror on
disk serves the same files offline.
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import urllib.request
import zipfile
from pathlib import Path
from typing import Dict, List, Optional

log = logging.getLogger(__name__)

PROTEINGYM_VERSION = "v1.1"
BASE_URL = "https://marks.hms.harvard.edu/proteingym/ProteinGym_{version}/{filename}"

# (name, filename, sha256, raw) — the published manifest
# (ref download.py:59-84 / README "Resources" table)
RESOURCES = [
    ("DMS_ProteinGym_substitutions", "DMS_ProteinGym_substitutions.zip",
     "3a83766254ac9ac9984ec25cb73c6e010ea4418f5e35f143933e6b6e6473b921", False),
    ("DMS_ProteinGym_indels", "DMS_ProteinGym_indels.zip",
     "5c5c7446a8c8f89534dfa87e546d2f9c00590d19aa5ce4c01d271abc7c962f74", False),
    ("zero_shot_substitutions_scores", "zero_shot_substitutions_scores.zip",
     "22df5c0f47e8278b39d0c1a51518e20d674b5109e136578bbede660af2bd7ecd", False),
    ("zero_shot_indels_scores", "zero_shot_indels_scores.zip",
     "957dc5d0d3e4163f56b3d45b865150a44fcd8ea9e2cf172e9c3fbbac2e344d81", False),
    ("DMS_supervised_substitutions_scores",
     "DMS_supervised_substitutions_scores.zip",
     "8167ff7eee01e748a7820034940847f888532cb2c942bc9ae18e413f77bce2cb", False),
    ("DMS_supervised_indels_scores", "DMS_supervised_indels_scores.zip",
     "3cf375bc9ae80b878e6c55ddeade2ef5f2895d479e4d414872d205007351bf15", False),
    ("DMS_msa_files", "DMS_msa_files.zip",
     "f8c894f0f113f5f49f2945c512b73f488bdf582097dff04658fbb703d92fe34d", False),
    ("DMS_msa_weights", "DMS_msa_weights.zip",
     "2f36a2a7882b264142eca273255da659fc8640249234edf934ffef364a585084", False),
    ("ProteinGym_AF2_structures", "ProteinGym_AF2_structures.zip",
     "c78f5ff60cf59104fe19b8318c5647587aad033ee832e051d0efec8e137c423a", False),
    ("clinical_ProteinGym_substitutions",
     "clinical_ProteinGym_substitutions.zip",
     "afe711af49365bc1ee220a5d212c570a4d9bc35e6960d19a93a0d1ed4ce37be4", False),
    ("clinical_ProteinGym_indels", "clinical_ProteinGym_indels.zip",
     "644192ef474998346ff760c3b3d6d0d731aebf79ce3c5057e3f2748c687128d6", False),
    ("clinical_msa_files", "clinical_msa_files.zip",
     "9f55b0792419f0f7f0d64f39f5345bb1510db5e02fb7a85347db3b0d2f8b3531", False),
    ("clinical_msa_weights", "clinical_msa_weights.zip",
     "564bbef2a6f22e544fc88ea49a31f1d1e585ad663e17d4d1e5f78f06a412fa49", False),
    ("zero_shot_clinical_substitutions_scores",
     "zero_shot_clinical_substitutions_scores.zip",
     "8bd9bbfe2a686974072f28c10cb1e0418f37c44a1fddf6e6b820f06b5f4b6515", False),
    ("zero_shot_clinical_indels_scores",
     "zero_shot_clinical_indels_scores.zip",
     "1834dfe2a43e34529eea77c1dbe7b0503153578455b7b146856b31268ee17aa7", False),
    ("cv_folds_singles_substitutions", "cv_folds_singles_substitutions.zip",
     "920f0be936233b96b5052cd23679e42355cfd2b4e6f45b4f571eb79c0b2f9c35", False),
    ("cv_folds_multiples_substitutions",
     "cv_folds_multiples_substitutions.zip",
     "4f1453ee8ccf2d38f23ae43f97fc7f962e54e5f10390711b59f6929538dd25f9", False),
    ("cv_folds_indels", "cv_folds_indels.zip",
     "b3f123321b499b470da03ddd3530241502851152f9a98775ecd6b508ae9c856d", False),
    ("substitutions_raw_DMS", "substitutions_raw_DMS.zip",
     "6d83b16585de2b71b67ae1985193b9eec2e01804784286c515ff276b5372e412", True),
    ("indels_raw_DMS", "indels_raw_DMS.zip",
     "93c21d4cdc09755428e417e330fdf7b3bf16705f125b23df208648b3ca5595a0", True),
    ("substitutions_raw_clinical", "substitutions_raw_clinical.zip",
     "caa461bd2e0c58501131e7c1ad9d26c118c67704efe1b67c7ff7ca1d72ae7275", True),
    ("indels_raw_clinical", "indels_raw_clinical.zip",
     "f9eb7232657ab5732eda8dcb922bf17b228eae212ca794e753ba73a017f40a8d", True),
]


def default_cache() -> Path:
    return Path(
        os.environ.get(
            "PROTEINGYM_CACHE",
            Path.home() / ".cache" / "proteingym_tpu",
        )
    )


def sha256_of(path: Path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            blob = f.read(chunk)
            if not blob:
                break
            h.update(blob)
    return h.hexdigest()


def fetch_file(
    url: str,
    dest: Path,
    expected_sha256: Optional[str] = None,
    force: bool = False,
) -> Path:
    """Download with atomic rename + hash verification."""
    dest.parent.mkdir(parents=True, exist_ok=True)
    if dest.exists() and not force:
        if expected_sha256 is None or sha256_of(dest) == expected_sha256:
            return dest
        log.warning("hash mismatch for cached %s; re-downloading", dest)
    tmp = dest.with_suffix(dest.suffix + ".part")
    log.info("downloading %s", url)
    with urllib.request.urlopen(url) as resp, open(tmp, "wb") as out:
        shutil.copyfileobj(resp, out)
    if expected_sha256 is not None:
        got = sha256_of(tmp)
        if got != expected_sha256:
            tmp.unlink(missing_ok=True)
            raise ValueError(
                f"SHA256 mismatch for {url}: got {got}, "
                f"expected {expected_sha256}"
            )
    tmp.rename(dest)
    return dest


def unzip(archive: Path, extract_dir: Path) -> List[str]:
    extract_dir.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(archive) as zf:
        zf.extractall(extract_dir)
        return [str(extract_dir / n) for n in zf.namelist()
                if not n.endswith("/")]


def download_resources(
    names: Optional[List[str]] = None,
    cache: Optional[str | Path] = None,
    version: str = PROTEINGYM_VERSION,
    remove_zip: bool = True,
    force: bool = False,
) -> Dict[str, List[str]]:
    """Fetch + verify + unzip the requested resources.

    Returns {resource_name: [extracted file paths]} (the reference's
    file_dict contract, ref download.py:135-166). Skips resources whose
    extraction directory already exists unless ``force``.
    """
    cache = Path(cache) if cache else default_cache()
    table = {name: (fn, sha, raw) for name, fn, sha, raw in RESOURCES}
    if names is None:
        names = list(table)
    out: Dict[str, List[str]] = {}
    for name in names:
        if name not in table:
            raise KeyError(
                f"Unknown resource {name!r}; available: {sorted(table)}"
            )
        filename, sha, _raw = table[name]
        extract_dir = cache / name
        done_marker = extract_dir / ".pgym_complete"
        # only a COMPLETE extraction counts — a bare directory may be the
        # debris of an interrupted unzip and must be redone
        if done_marker.exists() and not force:
            out[name] = [
                str(p) for p in extract_dir.rglob("*")
                if p.is_file() and p.name != ".pgym_complete"
            ]
            log.info("skipping %s (already extracted)", name)
            continue
        url = BASE_URL.format(version=version, filename=filename)
        archive = fetch_file(url, cache / filename, expected_sha256=sha,
                             force=force)
        out[name] = unzip(archive, extract_dir)
        done_marker.write_text("")
        if remove_zip:
            archive.unlink(missing_ok=True)
    return out


def count_resources(resources: Dict[str, List[str]]) -> Dict[str, str]:
    return {k: f"{len(v)} file(s)" for k, v in resources.items()}
