"""ESM, PoET, MSA Transformer, Tranception, EVE and ProtGPT2 checkpoint
specs (counterpart of the ESM, Tranception, EVE and GPT-2 parts of
proteingym_tpu/pipeline/checkpoints.py, of the PoET branch of
``resolve_zoo_checkpoint`` and of the weight handling of the
``msa_transformer`` scorer in proteingym_tpu/pipeline/scorers.py). Orbax
directories hold JAX arrays and are refused. Each ``load_*_checkpoint``
runs inside the span ``pgym.load`` (``pipeline.profiler.span``)."""

from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Optional, Tuple

import torch

from proteingym_tpu_torch.models import ar_zoo, esm2, eve, msa_transformer, poet, tranception
from proteingym_tpu_torch.pipeline.profiler import LOAD, span


def _spanned(load):
    """``load`` inside the span ``pgym.load``."""

    @functools.wraps(load)
    def run(*args, **kwargs):
        with span(LOAD):
            return load(*args, **kwargs)

    return run


def _load_torch_state_dict(path: Path):
    # fair-esm checkpoints pickle their training args next to the weights,
    # which weights_only loading refuses; load only checkpoints you trust
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "model" in blob:  # fairseq/ESM layout
        return blob["model"], blob.get("cfg") or blob.get("args")
    if isinstance(blob, dict) and "model_state_dict" in blob:  # EVE layout
        return blob["model_state_dict"], None
    if isinstance(blob, dict) and isinstance(blob.get("state_dict"), dict):  # Lightning layout
        return blob["state_dict"], None
    return blob, None


def _esm_preset_from_filename(path: str) -> str:
    stem = Path(path).stem
    for preset in esm2.PRESETS:
        token = preset.rsplit("_", 1)[0]  # esm2_t33 / esm1v_t33 ...
        if stem.startswith(token):
            return preset
    raise ValueError(f"Cannot infer ESM preset from {path}")


@_spanned
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


@_spanned
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


@_spanned
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


# Tranception checkpoint specs: a preset name gives seeded random weights
TRANCEPTION_PRESETS = {spec: tranception.PRESETS[f"tranception_{spec.lower()}"]
                       for spec in ("Small", "Medium", "Large")}
# no spec: the tiny preset (float32 here, bf16 in the JAX package)
TRANCEPTION_TINY = tranception.TranceptionConfig("Tranception_tiny", 2, 64, 4,
                                                 dtype=torch.float32)
# the dtype an HF checkpoint runs in, as in the JAX package
HF_DTYPE = torch.bfloat16


@_spanned
def load_tranception_checkpoint(
    spec: Optional[str], device="cuda", seed: int = 0,
) -> Tuple[tranception.Tranception, tranception.TranceptionConfig]:
    """Resolve a Tranception checkpoint spec to (model on ``device``,
    config):
      - None -> the tiny 2 x 64 x 4 preset, random init from ``seed``
      - "Small", "Medium" or "Large" -> that preset (bf16), random init
      - an HF directory (config.json with n_layer, n_embd, n_head[, n_ctx]
        and pytorch_model.bin) -> its weights, run in ``HF_DTYPE``
    An orbax directory written by the JAX package is refused."""
    if spec is None or spec in TRANCEPTION_PRESETS:
        config = TRANCEPTION_PRESETS.get(spec, TRANCEPTION_TINY)
        return tranception.init_random(config, seed=seed, device=device), config
    path = Path(spec)
    if not (path / "pytorch_model.bin").exists():
        raise ValueError(
            f"{spec!r} is not a Tranception preset ({sorted(TRANCEPTION_PRESETS)}) nor an HF "
            "directory with pytorch_model.bin; orbax checkpoints are JAX-only"
        )
    hf = json.loads((path / "config.json").read_text())
    config = tranception.TranceptionConfig(
        name=hf.get("model_type", "tranception"), num_layers=hf["n_layer"],
        embed_dim=hf["n_embd"], num_heads=hf["n_head"], n_ctx=hf.get("n_ctx", 1024),
        dtype=HF_DTYPE,
    )
    state, _ = _load_torch_state_dict(path / "pytorch_model.bin")
    return tranception.load_hf_state_dict(state, config, device=device), config


@_spanned
def load_eve_checkpoint(spec, device="cuda") -> Tuple[eve.EveModel, eve.EveConfig]:
    """Resolve one EVE checkpoint spec, a reference EVE checkpoint file
    (the format the clinical reference's EVE_model_path column names), to
    (model on ``device``, config). An orbax directory is refused."""
    path = Path(spec)
    if not path.is_file():
        raise ValueError(f"{spec!r} is not an EVE checkpoint file; orbax checkpoint "
                         "directories are JAX-only")
    return eve.load_torch_checkpoint(path, device=device)


@_spanned
def load_gpt2_checkpoint(spec, default_config: Optional[ar_zoo.Gpt2Config] = None,
                         device="cuda") -> Tuple[ar_zoo.Gpt2, ar_zoo.Gpt2Config]:
    """Resolve a ProtGPT2 / GPT-2 checkpoint spec to (model on ``device``,
    config):
      - an HF directory: config.json (n_layer, n_embd, n_head, vocab_size,
        n_positions) and pytorch_model.bin, named after the directory;
      - a bare torch state dict file, read with ``default_config`` (the
        scorer's ProtGPT2 shape without one).
    GPT-2's Conv1D weights are (in, out) and stay so. An orbax directory
    written by the JAX package, or an HF directory holding only
    model.safetensors (no safetensors here), is refused."""
    path = Path(spec)
    config = default_config or ar_zoo.Gpt2Config()
    if path.is_dir():
        if (path / "params").exists():
            raise ValueError(f"{spec!r} is an orbax checkpoint directory; those are JAX-only")
        if not (path / "pytorch_model.bin").exists():
            raise ValueError(f"{spec!r} holds no pytorch_model.bin")
        hf = json.loads((path / "config.json").read_text())
        config = ar_zoo.Gpt2Config(
            name=path.name, num_layers=int(hf["n_layer"]), embed_dim=int(hf["n_embd"]),
            num_heads=int(hf["n_head"]), vocab_size=int(hf["vocab_size"]),
            n_ctx=int(hf.get("n_positions", hf.get("n_ctx", 1024))), dtype=config.dtype,
        )
        path = path / "pytorch_model.bin"
    state, _ = _load_torch_state_dict(path)
    return ar_zoo.gpt2_load_state_dict(state, config, device=device), config


def _block_count(state, prefix: str) -> int:
    """1 + the largest N of the ``{prefix}N.`` keys of a state dict (0 if none)."""
    found = [int(k[len(prefix):].split(".", 1)[0]) for k in state
             if k.startswith(prefix) and k[len(prefix):].split(".", 1)[0].isdigit()]
    return 1 + max(found) if found else 0


def resolve_preset_state(spec: Optional[str], presets: dict, default: str, family: str,
                         shape_of=None, dims=None, params=None):
    """A --checkpoint spec of a preset family -> (config, state dict or None).

    - ``params`` (a library call's ``extra["params"]``): that state dict,
      with the preset ``spec`` names (``default`` without one);
    - None or a preset name: that preset and None (seeded random weights);
    - a published torch state dict file, whose preset is the one with
      ``dims(config) == shape_of(state)``, its (layers, width) (``shape_of``
      None: the family takes presets only);
    - an orbax directory (JAX-only) or anything else raises."""
    name = spec or default
    if params is not None or spec is None or spec in presets:
        if name not in presets:
            raise ValueError(f"Unknown {family} preset {name!r} (presets: {sorted(presets)})")
        return presets[name], params
    path = Path(spec)
    if path.is_dir():
        raise ValueError(f"{spec!r} is a directory: orbax checkpoints written by 'pgym convert' "
                         "are JAX-only; pass the published torch state dict file")
    if shape_of is None or not path.is_file():
        raise ValueError(f"Unknown {family} checkpoint {spec!r}: not a preset "
                         f"({sorted(presets)})" + ("" if shape_of is None else " and not a file"))
    state, _ = _load_torch_state_dict(path)
    shape = shape_of(state)
    for config in presets.values():
        if dims(config) == shape:
            return config, state
    raise ValueError(f"{spec}: {family} state dict of (layers, width) {shape} matches no preset "
                     f"({sorted(presets)})")
