"""Task manifest with done-markers for idempotent, resumable runs
(counterpart of proteingym_tpu/pipeline/manifest.py; the same records).

The reference's recovery story is skip-existing flags per scorer
(ref: esm/compute_fitness.py:365-370, EVE/compute_evol_indices_DMS.py:51-60);
here a single manifest generalizes it: each (model, assay) task records
done/failed state so any phase can be re-run and picks up where it left off.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional


class Manifest:
    """``read_only``: the state is read and kept, nothing is written (a
    rank of a mesh other than rank 0)."""

    def __init__(self, path: str | Path, read_only: bool = False):
        self.path = Path(path)
        self.read_only = read_only
        self.state: Dict[str, dict] = {}
        if self.path.exists():
            with open(self.path) as f:
                for line in f:
                    if line.strip():
                        rec = json.loads(line)
                        self.state[rec["task"]] = rec

    def _append(self, rec: dict) -> None:
        if self.read_only:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def is_done(self, task: str) -> bool:
        return self.state.get(task, {}).get("status") == "done"

    def mark_done(self, task: str, **fields) -> None:
        rec = {"task": task, "status": "done", "ts": time.time(), **fields}
        self.state[task] = rec
        self._append(rec)

    def mark_failed(self, task: str, error: str, **fields) -> None:
        rec = {
            "task": task,
            "status": "failed",
            "error": error,
            "ts": time.time(),
            **fields,
        }
        self.state[task] = rec
        self._append(rec)

    def pending(self, tasks) -> list:
        return [t for t in tasks if not self.is_done(t)]
