"""Content-addressed artifact cache for weights/priors (the port's own copy
of proteingym_tpu/pipeline/cache.py: the same keys, the same files).

The reference caches expensive intermediates ad hoc — MSA weights as .npy
keyed by filename (ref utils/msa_utils.py:219-241), TranceptEVE EVE
log-priors as pickles keyed by sample count (ref trancepteve/
model_pytorch.py:949-970). Here one content-addressed cache generalizes
both: keys are SHA256 hashes of the declared inputs, so a changed MSA,
seed, or sample count can never serve a stale artifact. The same inputs
give the JAX function's hex key, and both read and write the same
``<root>/<namespace>/<key>.npz`` files (``PGYM_CACHE``, else
``~/.cache/proteingym_tpu/artifacts``).
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np


def default_cache_dir() -> Path:
    return Path(
        os.environ.get(
            "PGYM_CACHE", Path.home() / ".cache" / "proteingym_tpu" / "artifacts"
        )
    )


def content_key(**inputs: Any) -> str:
    """Stable SHA256 over the declared inputs. Arrays hash their bytes."""
    h = hashlib.sha256()
    for name in sorted(inputs):
        v = inputs[name]
        h.update(name.encode())
        if isinstance(v, np.ndarray):
            h.update(str(v.shape).encode())
            h.update(str(v.dtype).encode())
            h.update(np.ascontiguousarray(v).tobytes())
        elif isinstance(v, (bytes, bytearray)):
            h.update(bytes(v))
        else:
            h.update(json.dumps(v, sort_keys=True, default=str).encode())
    return h.hexdigest()


class ArtifactCache:
    def __init__(self, root: Optional[str | Path] = None):
        self.root = Path(root) if root else default_cache_dir()

    def _path(self, namespace: str, key: str) -> Path:
        return self.root / namespace / f"{key}.npz"

    def get(self, namespace: str, key: str) -> Optional[dict]:
        path = self._path(namespace, key)
        if not path.exists():
            return None
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    def put(self, namespace: str, key: str, **arrays: np.ndarray) -> Path:
        path = self._path(namespace, key)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp.npz")
        np.savez(tmp, **arrays)
        tmp.rename(path)
        return path

    def get_or_compute(
        self,
        namespace: str,
        compute: Callable[[], dict],
        **key_inputs: Any,
    ) -> dict:
        """Return the cached arrays for these inputs, computing + storing on
        miss. ``compute`` must return a {name: ndarray} dict."""
        key = content_key(**key_inputs)
        hit = self.get(namespace, key)
        if hit is not None:
            return hit
        out = {k: np.asarray(v) for k, v in compute().items()}
        self.put(namespace, key, **out)
        return out
