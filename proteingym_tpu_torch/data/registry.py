"""Model registry: which score columns exist and how to merge and orient
them (counterpart of proteingym_tpu/data/registry.py, stdlib only).

Reads the ProteinGym ``config.json`` schema (per model: input_score_name,
location, directionality, key, model_type) and its display constants, or
the port's packaged registry, ``proteingym_tpu_torch/configs/registry.json``
and ``display.json`` (byte copies of the JAX package's, held equal by
tests/test_torch_shared_copies.py).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterable, Optional

CONFIGS_DIR = Path(__file__).resolve().parents[1] / "configs"

BENCHMARK_FIELDS = {
    ("DMS", "substitutions"): "model_list_zero_shot_substitutions_DMS",
    ("DMS", "indels"): "model_list_zero_shot_indels_DMS",
    ("clinical", "substitutions"): "model_list_zero_shot_substitutions_clinical",
    ("clinical", "indels"): "model_list_zero_shot_indels_clinical",
    ("DMS_supervised", "substitutions"): "model_list_supervised_substitutions_DMS",
    ("DMS_supervised", "indels"): "model_list_supervised_indels_DMS",
}


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    name: str
    input_score_name: str
    location: str
    directionality: int
    key: str
    model_type: str
    label_name: str = ""  # supervised models: target column in score files


class ModelRegistry:
    def __init__(
        self,
        models: Dict[str, ModelEntry],
        clean_names: Optional[Dict[str, str]] = None,
        model_details: Optional[Dict[str, str]] = None,
        model_references: Optional[Dict[str, str]] = None,
    ):
        self.models = models
        self.clean_names = clean_names or {}
        self.model_details = model_details or {}
        self.model_references = model_references or {}

    def __iter__(self) -> Iterable[ModelEntry]:
        return iter(self.models.values())

    def __len__(self) -> int:
        return len(self.models)

    def __getitem__(self, name: str) -> ModelEntry:
        return self.models[name]

    def __contains__(self, name: str) -> bool:
        return name in self.models

    @property
    def names(self):
        return list(self.models.keys())

    def clean_name(self, name: str) -> str:
        return self.clean_names.get(name, name)


def load_registry(
    config_path: str | Path,
    dataset: str = "DMS",
    mutation_type: str = "substitutions",
    constants_path: Optional[str | Path] = None,
) -> ModelRegistry:
    """Load a registry from a ProteinGym-format config.json."""
    with open(config_path) as f:
        config = json.load(f)
    field = BENCHMARK_FIELDS[(dataset, mutation_type)]
    models = {
        name: ModelEntry(
            name=name,
            input_score_name=spec["input_score_name"],
            location=spec["location"],
            directionality=int(spec.get("directionality", 1)),
            key=spec["key"],
            model_type=spec.get("model_type", ""),
            label_name=spec.get("label_name", ""),
        )
        for name, spec in config[field].items()
    }
    constants = {}
    if constants_path is not None:
        with open(constants_path) as f:
            constants = json.load(f)
    return ModelRegistry(models, constants.get("clean_names"),
                         constants.get("model_details"), constants.get("model_references"))


def load_packaged_registry(
    dataset: str = "DMS",
    mutation_type: str = "substitutions",
    with_display: bool = True,
) -> ModelRegistry:
    """The published ProteinGym model manifest shipped with the JAX package
    (97 zero-shot substitution models, 24 indel, 31/18 clinical, 11+3
    supervised)."""
    with open(CONFIGS_DIR / "registry.json") as f:
        table = json.load(f)
    models = {
        name: ModelEntry(
            name=name,
            input_score_name=spec["score_column"],
            location=spec["score_dir"],
            directionality=spec["directionality"],
            key=spec["merge_key"],
            model_type=spec.get("model_type", ""),
            label_name=spec.get("label_column", ""),
        )
        for name, spec in table["benchmarks"][f"{dataset}/{mutation_type}"].items()
    }
    display = {}
    if with_display:
        with open(CONFIGS_DIR / "display.json") as f:
            display = json.load(f)
    prefix = "supervised_" if dataset == "DMS_supervised" else ""
    return ModelRegistry(models, display.get(f"{prefix}clean_names"),
                         display.get(f"{prefix}model_details"),
                         display.get(f"{prefix}model_references"))


def registry_from_dict(models: Dict[str, dict]) -> ModelRegistry:
    return ModelRegistry({
        name: ModelEntry(
            name=name,
            input_score_name=spec.get("input_score_name", name),
            location=spec.get("location", name),
            directionality=int(spec.get("directionality", 1)),
            key=spec.get("key", "mutant"),
            model_type=spec.get("model_type", ""),
            label_name=spec.get("label_name", ""),
        )
        for name, spec in models.items()
    })
