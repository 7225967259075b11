"""``BENCHMARK.json`` and the files it names, resolved for one cell.

A cell is one entry of ``workloads``: one configuration under one traffic
mix. Everything that belongs to one configuration, mix, metric or cell is
found by its name, so that a later change adds files and entries and
edits none:

- ``configs/<config>.json`` (the path that ``configs[].file`` gives): the
  sizes, precision and init, and ``family``, the adapter in
  ``families/<family>.py``;
- ``traffic/<traffic>.json``: the mix's parameters, and ``kind``, its
  generator and entry call in ``kinds/<kind>.py``;
- ``metrics/<metric>.py``: the reader of a metric, end-to-end or per
  layer. A quantity split by the end-to-end metric it moves in different
  cells (``<metric>.<tag>``) is read by ``metrics/<metric>.py`` unless
  ``metrics/<metric>.<tag>.py`` is there;
- ``checks/<workload>.json``: the limits that decide ``correct``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

_MODULES: Dict[Path, ModuleType] = {}


def load_module(path: Path) -> ModuleType:
    """The Python file at ``path`` as a module, loaded once a process. File
    names may hold dots (metric names do), so modules load by path."""
    path = Path(path).resolve()
    if path not in _MODULES:
        if not path.is_file():
            raise FileNotFoundError(f"no file {path}")
        name = "h100bench_x_" + re.sub(r"\W", "_", str(path))
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
        _MODULES[path] = module
    return _MODULES[path]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    family: ModuleType
    kind: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, ModuleType]
    limits: Dict[str, float]


def reader_path(here: Path, name: str) -> Path:
    """The reader of metric ``name``: its own file, else that of the
    quantity it splits (``pad_share.short`` -> ``metrics/pad_share.py``)."""
    own = here / "metrics" / f"{name}.py"
    return own if own.is_file() or "." not in name else reader_path(here, name.rsplit(".", 1)[0])


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, with every file it
    names read and every module it names loaded."""
    root = Path(root)
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"there are {sorted(cells)}")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _json(root / cfg_entry["file"])
    here = root / "h100bench"
    traffic = _json(here / "traffic" / f"{w['traffic']}.json")
    end_to_end = [m for m in bench["end_to_end"] if _applies(m, workload)]
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload)]
    checks = _json(here / "checks" / f"{workload}.json")
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
        family=load_module(here / "families" / f"{config['family']}.py"),
        kind=load_module(here / "kinds" / f"{traffic['kind']}.py"),
        end_to_end=end_to_end,
        per_layer=per_layer,
        readers={m["name"]: load_module(reader_path(here, m["name"]))
                 for m in end_to_end + per_layer},
        limits={name: float(v["limit"]) for name, v in checks["limits"].items()},
    )
