"""Structured JSONL event log + per-phase timing (counterpart of
proteingym_tpu/pipeline/telemetry.py; the same records).

The reference's observability is print statements and tqdm bars
(SURVEY.md §5); here every pipeline phase emits structured events with
wall-clock fields, enabling mutants/sec accounting.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, Optional


class EventLog:
    def __init__(self, path: Optional[str | Path] = None, echo: bool = False):
        self.path = Path(path) if path else None
        self.echo = echo
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def emit(self, event: str, **fields: Any) -> None:
        record: Dict[str, Any] = {"ts": time.time(), "event": event, **fields}
        line = json.dumps(record, default=str)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.echo:
            print(line)

    @contextmanager
    def phase(self, name: str, **fields: Any):
        start = time.perf_counter()
        self.emit("phase_start", phase=name, **fields)
        try:
            yield self
        except Exception as e:
            self.emit(
                "phase_error",
                phase=name,
                error=repr(e),
                seconds=time.perf_counter() - start,
            )
            raise
        self.emit("phase_end", phase=name, seconds=time.perf_counter() - start, **fields)


NULL_LOG = EventLog(None)
