"""Model and tokenizer builder of the LLM trainer.

Counterpart of ``apps/trainer_llm/builder.py``: a custom builder file wins
(``make_model_and_tokenizer(config) -> (model, tokenizer)``); a known name
builds the port's phi or llama-family architecture; otherwise a local HF
snapshot whose ``config.json`` names a model type of
``models.transformer.HF_FAMILIES`` (the llama-graph families, the gemma3
and got_ocr2 wrappers' text paths, mixtral, and gpt2, gpt_neox, falcon,
starcoder2, stablelm, granite and cohere) or phi builds generically, its
checkpoint layout translated on load (``hf_loader.translator_for``).
Weights come from the snapshot
when one is given, else from a seeded ``torch.Generator``.  The tokenizer
comes from ``transformers`` where it is importable and resolves the name,
else it is the byte-level ``ByteTokenizer``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import logging
import pathlib
from typing import Any, Optional

import torch

from ... import models, utils
from ...models import hf_loader

__all__ = [
    "ByteTokenizer",
    "apply_decompose_config_and_state_dict",
    "log_linear_submodules",
    "make_model_and_tokenizer",
    "make_tokenizer",
    "str_to_dtype",
    "validate_module_names",
]

logger = logging.getLogger(__name__)

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}

# the JAX trainer's known configs whose architecture the port has
_KNOWN_CONFIGS = {
    "tiny": models.TransformerConfig.tiny,
    "tinyllama-1.1b": models.TransformerConfig.tinyllama_1_1b,
    "TinyLlama/TinyLlama-1.1B-Chat-v1.0": models.TransformerConfig.tinyllama_1_1b,
    "qwen2-1.5b": models.TransformerConfig.qwen2_1_5b,
    "Qwen/Qwen2-1.5B": models.TransformerConfig.qwen2_1_5b,
    "llama3-8b": models.TransformerConfig.llama3_8b,
    "meta-llama/Meta-Llama-3-8B": models.TransformerConfig.llama3_8b,
}

_PHI_CONFIGS = {
    "phi-2": models.PhiConfig.phi2,
    "microsoft/phi-2": models.PhiConfig.phi2,
    "phi-tiny": models.PhiConfig.tiny,
}

# alias -> canonical HF repo id, for tokenizer resolution
_HF_IDS = {
    "tinyllama-1.1b": "TinyLlama/TinyLlama-1.1B-Chat-v1.0",
    "qwen2-1.5b": "Qwen/Qwen2-1.5B",
    "llama3-8b": "meta-llama/Meta-Llama-3-8B",
    "phi-2": "microsoft/phi-2",
}

# the model types a snapshot's config.json may name
_GENERIC_MODEL_TYPES = (*models.transformer.HF_FAMILIES, "phi")


def str_to_dtype(s: str) -> torch.dtype:
    return _DTYPES[s]


def log_linear_submodules(m: torch.nn.Module) -> None:
    """Inventory of decomposable sites."""
    res = ["All Linear modules of the model:"]
    i = 1
    for name, mod in m.named_modules():
        if isinstance(mod, torch.nn.Linear):
            res.append(f"  - {name}  # ({i}) {mod.in_features}->{mod.out_features}")
            i += 1
    logger.info("\n".join(res))


def _load_custom_builder(path: str, config: Optional[dict[str, Any]]) -> tuple[torch.nn.Module, Any]:
    spec = importlib.util.spec_from_file_location("custom_builder", path)
    if spec is None or spec.loader is None:
        raise ImportError(f"Cannot load a custom builder from {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_model_and_tokenizer(config or {})


def make_model_and_tokenizer(
    *,
    model_name: str,
    model_revision: str = "main",
    dtype: str = "float32",
    custom_builder_path: Optional[str] = None,
    custom_builder_config: Optional[dict[str, Any]] = None,
    checkpoint_path: Optional[str] = None,
    enable_gradient_checkpointing: bool = False,
    seed: int = 0,
    device: Any = "cuda",
) -> tuple[torch.nn.Module, Any]:
    """``(model, tokenizer)``, the model on ``device``."""
    if custom_builder_path is not None:
        logger.info(f"Using custom builder {custom_builder_path}")
        model, tokenizer = _load_custom_builder(custom_builder_path, custom_builder_config)
        return model.to(device), tokenizer

    tdtype = str_to_dtype(dtype)
    snapshot_cfg = None
    if checkpoint_path is not None and (pathlib.Path(checkpoint_path) / "config.json").exists():
        snapshot_cfg = hf_loader.read_hf_config(checkpoint_path)
    remat = enable_gradient_checkpointing
    cfg: Any
    if model_name in _PHI_CONFIGS:
        cfg = dataclasses.replace(_PHI_CONFIGS[model_name](dtype=tdtype), remat=remat)
    elif model_name in _KNOWN_CONFIGS:
        cfg = dataclasses.replace(_KNOWN_CONFIGS[model_name](dtype=tdtype), remat=remat)
    elif snapshot_cfg is not None:
        # generic path: a snapshot of a family the port has builds from its
        # config.json
        mt = snapshot_cfg.get("model_type")
        logger.info(f"Building {model_name!r} generically from config.json (model_type={mt!r})")
        if mt not in _GENERIC_MODEL_TYPES:
            raise ValueError(
                f"model_type={mt!r}: the port builds {list(_GENERIC_MODEL_TYPES)} "
                "from a config.json"
            )
        config_cls = models.PhiConfig if mt == "phi" else models.TransformerConfig
        cfg = config_cls.from_hf_config(snapshot_cfg, dtype=tdtype, remat=remat)
    else:
        raise ValueError(
            f"Unknown model {model_name!r}; known: "
            f"{sorted(_KNOWN_CONFIGS) + sorted(_PHI_CONFIGS)} (or pass a checkpoint dir "
            "with a config.json of a family the port builds, or "
            "decomposed_model_custom_builder_path)"
        )
    if remat:
        logger.info("Per-block gradient checkpointing enabled")
    gen = torch.Generator(device=device).manual_seed(seed)
    model_cls = models.PhiCausalLM if isinstance(cfg, models.PhiConfig) else models.CausalLM
    model: torch.nn.Module = model_cls(cfg, device=device, generator=gen)

    if checkpoint_path is not None:
        translator = None if snapshot_cfg is None else hf_loader.translator_for(snapshot_cfg)
        hf_loader.load_into_causal_lm(model, checkpoint_path, key_translator=translator)
        logger.info(f"Loaded weights from {checkpoint_path}")
    else:
        logger.info("No checkpoint available - randomly initialized weights")

    tokenizer = make_tokenizer(model_name, cfg.vocab_size, checkpoint_path=checkpoint_path)
    log_linear_submodules(model)
    return model, tokenizer


class ByteTokenizer:
    """Offline fallback tokenizer (byte-level, vocab<=256+specials)."""

    def __init__(self, vocab_size: int) -> None:
        self.vocab_size = vocab_size
        self.eos_token = "\x00"
        self.eos_token_id = 0
        self.pad_token = "\x00"
        self.pad_token_id = 0

    def __call__(self, text: str, add_special_tokens: bool = False, **kw: Any):
        ids = [1 + (b % (self.vocab_size - 1)) for b in text.encode("utf-8")]
        return {"input_ids": ids}

    def decode(self, ids: list[int]) -> str:
        return bytes((i - 1) % 256 for i in ids if i > 0).decode("utf-8", errors="replace")


# files of which a snapshot needs one to hold a tokenizer
_TOKENIZER_FILES = ("tokenizer.json", "tokenizer.model", "tokenizer_config.json", "vocab.json")


def make_tokenizer(model_name: str, vocab_size: int, checkpoint_path: Optional[str] = None) -> Any:
    """A local HF snapshot's tokenizer first, then the canonical HF id of a
    known alias, then the name as given, through ``transformers``; the
    byte-level fallback last (and always, without ``transformers``).  A
    snapshot with no tokenizer file is skipped: ``transformers`` would
    build an empty tokenizer from its ``config.json`` alone."""
    candidates = []
    if checkpoint_path is not None and any(
        (pathlib.Path(checkpoint_path) / f).exists() for f in _TOKENIZER_FILES
    ):
        candidates.append(checkpoint_path)
    candidates.append(_HF_IDS.get(model_name, model_name))
    try:
        import transformers
    except ImportError as e:
        logger.warning(f"Falling back to ByteTokenizer ({e})")
        return ByteTokenizer(vocab_size)
    last_err: Any = None
    for cand in candidates:
        try:
            tok = transformers.AutoTokenizer.from_pretrained(cand)
            if tok.pad_token is None:
                tok.pad_token = tok.eos_token
            return tok
        except Exception as e:  # offline, or an unknown name: try the next
            last_err = e
    logger.warning(f"Falling back to ByteTokenizer ({last_err})")
    return ByteTokenizer(vocab_size)


def apply_decompose_config_and_state_dict(
    model: torch.nn.Module, decompose_config_path: str, decompose_state_dict_path: str
) -> torch.nn.Module:
    """Rebuild a decomposed checkpoint in place; the state dict must hold
    every key of the decomposed model (a mismatched pair raises)."""
    with open(decompose_config_path) as f:
        decompose_config = json.load(f)
    utils.apply_decompose_config(model, decompose_config)
    sd_path = pathlib.Path(decompose_state_dict_path)
    if sd_path.suffix == ".safetensors":
        sd = utils.load_state_dict_safetensors(str(sd_path))
    else:
        sd = utils.load_state_dict_pt(str(sd_path))
    own = set(model.state_dict().keys())
    missing = own - set(sd.keys())
    if missing:
        raise KeyError(
            f"decompose_state_dict is missing {len(missing)} keys the decomposed model needs "
            f"(first: {sorted(missing)[:5]}) — config/state-dict mismatch?"
        )
    unexpected = set(sd.keys()) - own
    if unexpected:
        logger.warning(
            f"decompose_state_dict has {len(unexpected)} unused keys (first: {sorted(unexpected)[:5]})"
        )
    utils.load_state_dict(model, sd, strict=False)
    return model


def validate_module_names(model: torch.nn.Module, names: Optional[list[str]]) -> None:
    """Fail fast on a blacklist entry that names no module."""
    if names is None:
        return
    known = {name for name, _ in model.named_modules()}
    unknown = [n for n in names if n not in known]
    if unknown:
        raise ValueError(f"Unknown module names: {unknown}")
