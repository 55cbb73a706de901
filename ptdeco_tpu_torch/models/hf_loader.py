"""Load local HuggingFace checkpoints into the port's models.

Counterpart of the llama-family and phi part of
``ptdeco_tpu/models/hf_loader.py``: the port's parameter names are HF's
(``model.layers.0.self_attn.q_proj.weight``, phi's
``model.layers.0.self_attn.dense.weight`` ...) and in torch layout, so an
HF state dict of a llama, mistral, qwen2, qwen3, gemma or phi snapshot
loads as it is (a tied model needs no ``lm_head.weight``; one the snapshot
holds anyway is ignored); Mixtral's expert names are translated.  Shards
are read from ``*.safetensors`` where that package is importable, else
from ``pytorch_model*.bin`` with ``torch.load``.
"""

from __future__ import annotations

import importlib.util
import json
import logging
import pathlib
from typing import Any, Callable, Optional

import torch

from .. import utils

__all__ = [
    "read_hf_config",
    "read_hf_state_dict",
    "load_into_causal_lm",
    "translate_mixtral_state_dict",
    "translator_for",
]

logger = logging.getLogger(__name__)

KeyTranslator = Callable[[dict[str, torch.Tensor]], dict[str, torch.Tensor]]


def read_hf_config(checkpoint_dir: str) -> dict[str, Any]:
    with open(pathlib.Path(checkpoint_dir) / "config.json") as f:
        return json.load(f)


def read_hf_state_dict(checkpoint_dir: str) -> dict[str, torch.Tensor]:
    """Every shard of a local HF snapshot directory, on the CPU."""
    d = pathlib.Path(checkpoint_dir)
    sd: dict[str, torch.Tensor] = {}
    shards = sorted(d.glob("*.safetensors"))
    if shards and importlib.util.find_spec("safetensors") is not None:
        for shard in shards:
            sd.update(utils.load_state_dict_safetensors(str(shard)))
        return sd
    bins = sorted(d.glob("pytorch_model*.bin"))
    if bins:
        for b in bins:
            sd.update(utils.load_state_dict_pt(str(b)))
        return sd
    if shards:
        raise FileNotFoundError(
            f"{checkpoint_dir} holds only safetensors shards and safetensors is not installed"
        )
    raise FileNotFoundError(f"No checkpoint shards found in {checkpoint_dir}")


def load_into_causal_lm(
    model: torch.nn.Module, checkpoint_dir: str, key_translator: Optional[KeyTranslator] = None
) -> torch.nn.Module:
    """Copy the snapshot's weights into ``model`` in place (cast to each
    parameter's dtype and device).  Keys the model does not have (rotary
    buffers ...) are ignored; parameters the snapshot lacks are logged."""
    sd = read_hf_state_dict(checkpoint_dir)
    if key_translator is not None:
        sd = key_translator(sd)
    utils.load_state_dict(model, sd, strict=False)
    missing = set(model.state_dict().keys()) - set(sd.keys())
    if missing:
        logger.warning(f"Keys missing from checkpoint: {sorted(missing)[:10]}...")
    return model


def translate_mixtral_state_dict(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """HF Mixtral's ``block_sparse_moe`` with experts ``w1/w3/w2`` into the
    ``MoEMLP`` names ``mlp`` and ``gate_proj/up_proj/down_proj``; the router
    ``block_sparse_moe.gate`` becomes ``mlp.gate``."""
    out: dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if ".block_sparse_moe." in k:
            k = k.replace(".block_sparse_moe.", ".mlp.")
            for old, new in ((".w1.", ".gate_proj."), (".w3.", ".up_proj."), (".w2.", ".down_proj.")):
                if old in k:
                    k = k.replace(old, new)
                    break
        out[k] = v
    return out


# model types whose HF names are the port model's own
_SAME_NAMES = ("llama", "mistral", "qwen2", "qwen3", "gemma", "phi")


def translator_for(hf_cfg: dict[str, Any]) -> Optional[KeyTranslator]:
    """The checkpoint-layout translator for a config's ``model_type``: None
    where HF's names are the model's already.  Raises for a model type the
    port has no model for."""
    mt = hf_cfg.get("model_type")
    if mt in _SAME_NAMES:
        return None
    if mt == "mixtral":
        return translate_mixtral_state_dict
    raise ValueError(
        f"model_type={mt!r}: the port has models for {list(_SAME_NAMES)} and mixtral only"
    )
