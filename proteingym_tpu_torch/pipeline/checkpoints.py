"""ESM, PoET and MSA Transformer checkpoint specs (counterpart of the ESM
part of proteingym_tpu/pipeline/checkpoints.py, of the PoET branch of
``resolve_zoo_checkpoint`` and of the weight handling of the
``msa_transformer`` scorer in proteingym_tpu/pipeline/scorers.py)."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import torch

from proteingym_tpu_torch.models import esm2, msa_transformer, poet


def _load_torch_state_dict(path: Path):
    # fair-esm checkpoints pickle their training args next to the weights,
    # which weights_only loading refuses; load only checkpoints you trust
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "model" in blob:  # fairseq/ESM layout
        return blob["model"], blob.get("cfg") or blob.get("args")
    if isinstance(blob, dict) and "model_state_dict" in blob:  # EVE layout
        return blob["model_state_dict"], None
    return blob, None


def _esm_preset_from_filename(path: str) -> str:
    stem = Path(path).stem
    for preset in esm2.PRESETS:
        token = preset.rsplit("_", 1)[0]  # esm2_t33 / esm1v_t33 ...
        if stem.startswith(token):
            return preset
    raise ValueError(f"Cannot infer ESM preset from {path}")


def load_esm_checkpoint(spec: Optional[str], device="cuda",
                        seed: int = 0) -> Tuple[esm2.EsmModel, esm2.EsmConfig]:
    """Resolve an ESM checkpoint spec to (model on ``device``, config).

    spec is one of:
      - a preset name ("esm2_t33_650M", ...) -> random init from ``seed``
      - "<preset>:<path.pt>" (empty preset: inferred from the file name)
        -> the fair-esm state dict in the file
      - a bare "*.pt" fair-esm file, preset inferred from its name
    A 'pgym convert' (orbax) directory holds JAX arrays and is refused.
    """
    if spec is None:
        raise ValueError(
            "esm scoring needs --checkpoint: a preset name (random init, "
            f"e.g. one of {sorted(esm2.PRESETS)}), '<preset>:<path.pt>' or a "
            "fair-esm .pt file"
        )
    if spec in esm2.PRESETS:
        config = esm2.PRESETS[spec]
        return esm2.init_random(config, seed=seed, device=device), config
    if ":" in spec:
        preset, path = spec.split(":", 1)
        preset = preset or _esm_preset_from_filename(path)
    elif Path(spec).suffix == ".pt":
        preset, path = _esm_preset_from_filename(spec), spec
    elif Path(spec).is_dir():
        raise ValueError(
            f"{spec} is a directory: orbax checkpoints written by 'pgym convert' "
            "are JAX-only; pass the fair-esm .pt file instead"
        )
    else:
        raise ValueError(f"unrecognised ESM checkpoint spec {spec!r}")
    config = esm2.PRESETS[preset]
    state, _ = _load_torch_state_dict(Path(path))
    return esm2.load_fair_esm_state_dict(state, config, device=device), config


def load_poet_checkpoint(spec: Optional[str], device="cuda",
                         seed: int = 0) -> Tuple[poet.PoetModel, poet.PoetConfig]:
    """Resolve a PoET checkpoint spec to (model on ``device``, config).

    spec is one of:
      - None or a preset name ("poet_tiny", "poet_200m") -> random init
        from ``seed`` (None means "poet_tiny", the JAX scorer's default)
      - "<preset>:<path>" -> the PoET torch state dict in the file (a bare
        state dict, or one under "model", "model_state_dict" or a
        Lightning-style "state_dict" with "model." key prefixes)
    A 'pgym convert' (orbax) directory holds JAX arrays and is refused.
    """
    if not spec:
        spec = "poet_tiny"
    if spec in poet.POET_PRESETS:
        config = poet.POET_PRESETS[spec]
        return poet.init_random(config, seed=seed, device=device), config
    if Path(spec).is_dir():
        raise ValueError(
            f"{spec} is a directory: orbax checkpoints written by 'pgym convert' "
            "are JAX-only; pass '<preset>:<path>' to the PoET torch checkpoint"
        )
    preset, sep, path = spec.partition(":")
    if not sep or preset not in poet.POET_PRESETS:
        raise ValueError(
            f"unrecognised PoET checkpoint spec {spec!r}: expected a preset "
            f"({sorted(poet.POET_PRESETS)}) or '<preset>:<path>'"
        )
    config = poet.POET_PRESETS[preset]
    blob = torch.load(Path(path), map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "state_dict" in blob:  # Lightning layout
        state = {k.split(".", 1)[1] if k.startswith("model.") else k: v
                 for k, v in blob["state_dict"].items()}
    else:
        state, _ = _load_torch_state_dict(Path(path))
    model = poet._empty_model(config, device)
    return poet.load_state_dict_poet(model, state), config


def load_msa_transformer_checkpoint(
    spec: Optional[str], device="cuda", seed: int = 0,
) -> Tuple[msa_transformer.MsaTransformer, msa_transformer.MsaTransformerConfig]:
    """Resolve an MSA Transformer checkpoint spec to (model on ``device``,
    config), as the JAX scorer does:
      - None or a preset name ("esm_msa1b_t12_100M", "msa_tiny") -> random
        init from ``seed`` (None means the full ``esm_msa1b_t12_100M``)
      - anything else is a path to a fair-esm ``MSATransformer`` checkpoint,
        read with the full ``esm_msa1b_t12_100M`` config
    """
    presets = msa_transformer.PRESETS
    if not spec or spec in presets:
        config = presets[spec or "esm_msa1b_t12_100M"]
        return msa_transformer.init_random(config, seed=seed, device=device), config
    config = presets["esm_msa1b_t12_100M"]
    state, _ = _load_torch_state_dict(Path(spec))
    return msa_transformer.load_fair_esm_state_dict(state, config, device=device), config
