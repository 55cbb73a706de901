"""Load local HuggingFace checkpoints into the port's models.

Counterpart of the llama-family and phi part of
``ptdeco_tpu/models/hf_loader.py``: the port's parameter names are HF's
(``model.layers.0.self_attn.q_proj.weight``, phi's
``model.layers.0.self_attn.dense.weight`` ...) and in torch layout, so an
HF state dict of a llama, code_llama, mistral, ministral, qwen2, qwen3,
gemma, gemma2, gemma3_text, olmo2, olmo3, smollm3 or phi snapshot loads as
it is, and so does one of stablelm, granite or cohere (a tied model needs
no ``lm_head.weight``; one the snapshot holds anyway is ignored);
Mixtral's expert names are translated, phi3's, glm's and glm4's fused
projections split, glm4's norms renamed onto the sandwich slots and the
gemma3 and got_ocr2 wrappers' text paths unwrapped; GPT-2's Conv1D
projections are transposed and its ``c_attn`` split, GPT-NeoX's and
Falcon's fused ``query_key_value`` split by their layouts, and
StarCoder2's MLP renamed; GPT-1's, gpt-sw3's and ImageGPT's Conv1D
layouts go through GPT-2's translator (ImageGPT's untied head kept),
GPT-J's, GPT-Neo's and OPT's names are renamed (OPT's two legacy position
rows dropped), CodeGen's sharded (q, v, k) ``qkv_proj`` and StarCoder's
multi-query ``c_attn`` split; emu3's text path keeps llama's names, and
so do olmo, nemotron, ernie4_5, arcee, seed_oss, exaone4, helium, cohere2
and bitnet; Persimmon's, BLOOM's and GPT-NeoX-Japanese's per-head fused
``query_key_value`` is split as GPT-NeoX's (and through the fuyu wrapper;
GPT-NeoX-Japanese's o_proj biases zero-filled but the last layer's), MPT's
``Wqkv`` cut in [q | k | v], VaultGemma's, Apertus's (its xIELU scalars
too), HunYuan's, open-llama's, XGLM's, BioGPT's (its two offset rows
dropped), CTRL's and XLM's names are renamed (the last two's head biases
onto ``tied_head_bias``); doge's ``A`` is renamed, moshi's ``.linear``
nesting unwrapped and its fused ``fc1`` split, and mllama's wrapper
prefixes stripped with its vision tower and cross-attention layers
dropped; diffllama keeps llama's names; DeepSeek's plural shared experts
and its router's correction bias are renamed.  A translator takes numpy arrays or tensors.
Shards are read from ``*.safetensors`` where that package is importable,
else from ``pytorch_model*.bin`` with ``torch.load``.
"""

from __future__ import annotations

import importlib.util
import json
import logging
import pathlib
from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import utils
from .transformer import WRAPPED_TEXT_TYPES

__all__ = [
    "read_hf_config",
    "read_hf_state_dict",
    "load_into_causal_lm",
    "translate_mixtral_state_dict",
    "split_phi3_fused_projections",
    "translate_glm4_state_dict",
    "translate_glm_state_dict",
    "make_multimodal_text_translator",
    "translate_gpt2_state_dict",
    "make_gpt_neox_translator",
    "make_falcon_translator",
    "translate_starcoder2_state_dict",
    "translate_imagegpt_state_dict",
    "translate_gptj_state_dict",
    "make_codegen_translator",
    "translate_gpt_neo_state_dict",
    "make_gpt_bigcode_translator",
    "translate_opt_state_dict",
    "make_persimmon_translator",
    "translate_vaultgemma_state_dict",
    "translate_apertus_state_dict",
    "translate_hunyuan_state_dict",
    "translate_open_llama_state_dict",
    "make_bloom_translator",
    "make_mpt_translator",
    "translate_xglm_state_dict",
    "translate_biogpt_state_dict",
    "translate_ctrl_state_dict",
    "translate_xlm_state_dict",
    "make_gpt_neox_japanese_translator",
    "translate_doge_state_dict",
    "translate_moshi_state_dict",
    "make_mllama_translator",
    "translate_deepseek_state_dict",
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


def split_phi3_fused_projections(
    sd: dict[str, torch.Tensor], n_heads: int, n_kv_heads: int, head_dim: int
) -> dict[str, torch.Tensor]:
    """phi3's fused layout into the llama one: ``self_attn.qkv_proj.weight``
    ((q + k + v) rows) splits into q/k/v_proj and ``mlp.gate_up_proj.weight``
    (2 * hidden rows) into gate/up_proj; every other key passes unchanged."""
    out: dict[str, torch.Tensor] = {}
    q_rows, kv_rows = n_heads * head_dim, n_kv_heads * head_dim
    for k, v in sd.items():
        if k.endswith(".self_attn.qkv_proj.weight"):
            stem = k[: -len("qkv_proj.weight")]
            out[stem + "q_proj.weight"] = v[:q_rows]
            out[stem + "k_proj.weight"] = v[q_rows : q_rows + kv_rows]
            out[stem + "v_proj.weight"] = v[q_rows + kv_rows :]
        elif not _split_gate_up(k, v, out):
            out[k] = v
    return out


def _split_gate_up(k: str, v: torch.Tensor, out: dict[str, torch.Tensor]) -> bool:
    """Split a fused ``mlp.gate_up_proj.weight`` in halves into ``out``;
    False for any other key."""
    if not k.endswith(".mlp.gate_up_proj.weight"):
        return False
    stem = k[: -len("gate_up_proj.weight")]
    half = v.shape[0] // 2
    out[stem + "gate_proj.weight"] = v[:half]
    out[stem + "up_proj.weight"] = v[half:]
    return True


# GLM-4's norm names -> the sandwich slots (HF Glm4DecoderLayer); each key
# matches one rule, so its post_attention_layernorm (the pre-MLP norm) never
# meets the slot of that name
_GLM4_NORMS = (
    (".post_self_attn_layernorm.", ".post_attention_layernorm."),
    (".post_attention_layernorm.", ".pre_feedforward_layernorm."),
    (".post_mlp_layernorm.", ".post_feedforward_layernorm."),
)


def translate_glm4_state_dict(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """GLM-4's layout into the sandwich names: ``post_self_attn_layernorm``
    (on the attention output) -> ``post_attention_layernorm``, its
    ``post_attention_layernorm`` (before the MLP) ->
    ``pre_feedforward_layernorm``, ``post_mlp_layernorm`` ->
    ``post_feedforward_layernorm``; ``mlp.gate_up_proj`` splits in halves
    into gate/up."""
    out: dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if _split_gate_up(k, v, out):
            continue
        for old, new in _GLM4_NORMS:
            if old in k:
                k = k.replace(old, new)
                break
        out[k] = v
    return out


def translate_glm_state_dict(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """GLM's layout (a pre-norm llama block): only ``mlp.gate_up_proj``
    splits in halves into gate/up."""
    out: dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if not _split_gate_up(k, v, out):
            out[k] = v
    return out


def _phi3_translator(hf_cfg: dict[str, Any]) -> KeyTranslator:
    """The phi3 split at the config's head counts."""
    n_heads = int(hf_cfg["num_attention_heads"])
    n_kv = int(hf_cfg.get("num_key_value_heads", n_heads))
    hd = int(hf_cfg.get("head_dim") or int(hf_cfg["hidden_size"]) // n_heads)
    return lambda sd: split_phi3_fused_projections(sd, n_heads, n_kv, hd)


def make_multimodal_text_translator(hf_cfg: dict[str, Any]) -> KeyTranslator:
    """The gemma3, got_ocr2 and fuyu wrappers: strip ``model.language_model.``
    to ``model.`` (fuyu's older layout nests its persimmon model one level
    shallower, under ``language_model.``), drop the vision tower, projector
    and patch embedding the text path never runs (and a tied
    ``lm_head.weight``; gemma3 is tied unless its text_config says
    otherwise, got_ocr2 and fuyu untied), then the inner family's
    translator (persimmon's split; gemma3_text and qwen2 need none)."""
    mt = hf_cfg["model_type"]
    inner_cfg = dict(hf_cfg.get("text_config") or {})
    inner_cfg.setdefault("model_type", WRAPPED_TEXT_TYPES[mt])
    inner = translator_for(inner_cfg)
    tied = bool(inner_cfg.get("tie_word_embeddings", mt == "gemma3"))
    drop = ("model.vision_tower.", "model.multi_modal_projector.", "model.vision_embed_tokens.",
            "vision_embed_tokens.")

    def translate(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        out: dict[str, torch.Tensor] = {}
        for k, v in sd.items():
            if k.startswith(drop) or (k == "lm_head.weight" and tied):
                continue
            k = k.replace("model.language_model.", "model.")
            out[k.removeprefix("language_model.")] = v
        return inner(out) if inner is not None else out

    return translate


def translate_gpt2_state_dict(sd: dict[str, Any]) -> dict[str, Any]:
    """GPT-2's layout (and GPT-1's and gpt-sw3's): its Conv1D projections
    hold (in, out), the transpose of a Linear's weight, so each weight is
    transposed and ``attn.c_attn`` split in thirds (q | k | v along the
    output); ``wte`` / ``wpe`` (GPT-1: ``tokens_embed`` /
    ``positions_embed``) -> ``embed_tokens`` / ``pos_embed``, ``ln_1`` /
    ``ln_2`` -> the input and post-attention norms (GPT-1 applies them
    after each residual add), ``attn.c_proj`` -> ``o_proj``, ``mlp.c_fc`` /
    ``mlp.c_proj`` -> up / down, ``ln_f`` -> ``model.norm``.  The
    causal-mask buffers and the tied ``lm_head`` are dropped."""
    conv1d = (".self_attn.o_proj.", ".mlp.up_proj.", ".mlp.down_proj.", ".attn.c_attn.")
    out: dict[str, Any] = {}
    for k, v in sd.items():
        if k.endswith((".attn.bias", ".attn.masked_bias")) or k == "lm_head.weight":
            continue
        for old, new in (("transformer.wte.", "model.embed_tokens."),
                         ("transformer.wpe.", "model.pos_embed."),
                         ("transformer.tokens_embed.", "model.embed_tokens."),
                         ("transformer.positions_embed.", "model.pos_embed."),
                         ("transformer.ln_f.", "model.norm."), ("transformer.h.", "model.layers."),
                         (".ln_1.", ".input_layernorm."), (".ln_2.", ".post_attention_layernorm."),
                         (".attn.c_proj.", ".self_attn.o_proj."), (".mlp.c_fc.", ".mlp.up_proj."),
                         (".mlp.c_proj.", ".mlp.down_proj.")):
            k = k.replace(old, new)
        if k.endswith(".weight") and any(c in k for c in conv1d):
            v = v.T
        if ".attn.c_attn." in k:
            stem, leaf = k.split(".attn.c_attn.")
            third = v.shape[0] // 3
            for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
                out[f"{stem}.self_attn.{name}.{leaf}"] = v[i * third:(i + 1) * third]
            continue
        out[k] = v
    return out


def _split_per_head_qkv(stem: str, leaf: str, v: Any, n_heads: int, hd: int,
                        out: dict[str, Any]) -> None:
    """A ``query_key_value`` fused a head at a time, rows [head 0: q k
    v][head 1: q k v]... (GPT-NeoX's and Persimmon's), split into
    ``{stem}.self_attn.{q,k,v}_proj.{leaf}`` of ``out``."""
    w = v.reshape(n_heads, 3, hd, *v.shape[1:])
    for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
        out[f"{stem}.self_attn.{name}.{leaf}"] = w[:, i].reshape(n_heads * hd, *v.shape[1:])


def make_gpt_neox_translator(hf_cfg: dict[str, Any]) -> KeyTranslator:
    """GPT-NeoX's layout: ``query_key_value`` fuses q/k/v per head, its
    rows [head 0: q k v][head 1: q k v]..., so its split takes the head
    count; ``embed_in`` -> ``embed_tokens``, ``attention.dense`` ->
    ``o_proj``, ``dense_h_to_4h`` / ``dense_4h_to_h`` -> up / down,
    ``final_layer_norm`` -> ``model.norm``, ``embed_out`` -> ``lm_head``;
    the mask and rotary buffers are dropped."""
    n_heads = int(hf_cfg["num_attention_heads"])
    hd = int(hf_cfg["hidden_size"]) // n_heads

    def translate(sd: dict[str, Any]) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for k, v in sd.items():
            if k.endswith((".attention.bias", ".attention.masked_bias", "rotary_emb.inv_freq")):
                continue
            for old, new in (("gpt_neox.embed_in.", "model.embed_tokens."),
                             ("gpt_neox.final_layer_norm.", "model.norm."),
                             ("gpt_neox.layers.", "model.layers."), ("embed_out.", "lm_head."),
                             (".attention.dense.", ".self_attn.o_proj."),
                             (".mlp.dense_h_to_4h.", ".mlp.up_proj."),
                             (".mlp.dense_4h_to_h.", ".mlp.down_proj.")):
                k = k.replace(old, new)
            if ".attention.query_key_value." in k:
                _split_per_head_qkv(*k.split(".attention.query_key_value."), v, n_heads, hd, out)
                continue
            out[k] = v
        return out

    return translate


def make_persimmon_translator(hf_cfg: dict[str, Any]) -> KeyTranslator:
    """Persimmon's layout: ``self_attn.query_key_value`` fused a head at a
    time as GPT-NeoX's, ``self_attn.dense`` -> ``o_proj``, ``q_layernorm``
    / ``k_layernorm`` -> ``q_norm`` / ``k_norm``, ``dense_h_to_4h`` /
    ``dense_4h_to_h`` -> up / down, ``final_layernorm`` -> ``model.norm``;
    the rotary buffers are dropped."""
    n_heads = int(hf_cfg["num_attention_heads"])
    hd = int(hf_cfg["hidden_size"]) // n_heads

    def translate(sd: dict[str, Any]) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for k, v in _renamed(sd, (
                ("model.final_layernorm.", "model.norm."),
                (".self_attn.dense.", ".self_attn.o_proj."),
                (".self_attn.q_layernorm.", ".self_attn.q_norm."),
                (".self_attn.k_layernorm.", ".self_attn.k_norm."),
                (".mlp.dense_h_to_4h.", ".mlp.up_proj."), (".mlp.dense_4h_to_h.", ".mlp.down_proj.")),
                drop=("rotary_emb.inv_freq",)).items():
            if ".self_attn.query_key_value." in k:
                _split_per_head_qkv(*k.split(".self_attn.query_key_value."), v, n_heads, hd, out)
            else:
                out[k] = v
        return out

    return translate


def translate_vaultgemma_state_dict(sd: dict[str, Any]) -> dict[str, Any]:
    """VaultGemma names the pre-MLP norm of its plain two-norm block
    ``pre_feedforward_layernorm``: renamed onto ``post_attention_layernorm``."""
    return _renamed(sd, ((".pre_feedforward_layernorm.", ".post_attention_layernorm."),))


def translate_apertus_state_dict(sd: dict[str, Any]) -> dict[str, Any]:
    """Apertus's block norms ``attention_layernorm`` / ``feedforward_layernorm``
    -> the input and post-attention norms, and its xIELU scalars
    ``mlp.act_fn.alpha_p`` / ``alpha_n`` -> ``mlp.act_alpha_p`` / ``act_alpha_n``."""
    return _renamed(sd, ((".attention_layernorm.", ".input_layernorm."),
                         (".feedforward_layernorm.", ".post_attention_layernorm."),
                         (".mlp.act_fn.alpha_p", ".mlp.act_alpha_p"),
                         (".mlp.act_fn.alpha_n", ".mlp.act_alpha_n")))


def translate_hunyuan_state_dict(sd: dict[str, Any]) -> dict[str, Any]:
    """HunYuan's (dense) per-head norms ``query_layernorm`` /
    ``key_layernorm`` -> ``q_norm`` / ``k_norm``."""
    return _renamed(sd, ((".self_attn.query_layernorm.", ".self_attn.q_norm."),
                         (".self_attn.key_layernorm.", ".self_attn.k_norm.")))


def translate_open_llama_state_dict(sd: dict[str, Any]) -> dict[str, Any]:
    """open-llama's layout is llama's with ``embed_layer_norm`` ->
    ``embed_norm``; the shared input/output embedding has no
    ``lm_head.weight`` of its own, and one a snapshot holds is dropped."""
    return {k: v for k, v in _renamed(sd, (("model.embed_layer_norm.", "model.embed_norm."),)).items()
            if k != "lm_head.weight"}


def make_falcon_translator(hf_cfg: dict[str, Any]) -> KeyTranslator:
    """Falcon's layout: the fused ``self_attention.query_key_value`` in one
    of three row orders (HF ``FalconAttention._split_heads``): the new
    decoder architecture's [q x heads / kv | k | v] a kv head, classic
    ``multi_query``'s q heads then one k and one v head, falcon-rw's per
    head [q k v] as GPT-NeoX's; ``word_embeddings`` -> ``embed_tokens``,
    ``ln_attn`` / ``ln_mlp`` -> the input and post-attention norms,
    ``self_attention.dense`` -> ``o_proj``, ``dense_h_to_4h`` /
    ``dense_4h_to_h`` -> up / down, ``ln_f`` -> ``model.norm``."""
    n_heads = int(hf_cfg["num_attention_heads"])
    hd = int(hf_cfg["hidden_size"]) // n_heads
    new_arch = bool(hf_cfg.get("new_decoder_architecture", False))
    multi_query = bool(hf_cfg.get("multi_query", True))
    n_kv = int(hf_cfg.get("num_kv_heads") or n_heads) if new_arch else 1 if multi_query else n_heads

    def split_qkv(v: Any) -> tuple[Any, Any, Any]:
        rest = v.shape[1:]
        if new_arch:
            g = n_heads // n_kv
            w = v.reshape(n_kv, g + 2, hd, *rest)
            return (w[:, :g].reshape(n_heads * hd, *rest), w[:, g].reshape(n_kv * hd, *rest),
                    w[:, g + 1].reshape(n_kv * hd, *rest))
        if multi_query:
            w = v.reshape(n_heads + 2, hd, *rest)
            return w[:n_heads].reshape(n_heads * hd, *rest), w[n_heads], w[n_heads + 1]
        w = v.reshape(n_heads, 3, hd, *rest)
        return tuple(w[:, i].reshape(n_heads * hd, *rest) for i in range(3))

    def translate(sd: dict[str, Any]) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for k, v in sd.items():
            if k.endswith("rotary_emb.inv_freq"):
                continue
            for old, new in (("transformer.word_embeddings.", "model.embed_tokens."),
                             ("transformer.ln_f.", "model.norm."),
                             ("transformer.h.", "model.layers."),
                             (".ln_attn.", ".input_layernorm."),
                             (".ln_mlp.", ".post_attention_layernorm."),
                             (".self_attention.dense.", ".self_attn.o_proj."),
                             (".mlp.dense_h_to_4h.", ".mlp.up_proj."),
                             (".mlp.dense_4h_to_h.", ".mlp.down_proj.")):
                k = k.replace(old, new)
            if ".self_attention.query_key_value." in k:
                stem, leaf = k.split(".self_attention.query_key_value.")
                for name, part in zip(("q_proj", "k_proj", "v_proj"), split_qkv(v)):
                    out[f"{stem}.self_attn.{name}.{leaf}"] = part
                continue
            out[k] = v
        return out

    return translate


def translate_starcoder2_state_dict(sd: dict[str, Any]) -> dict[str, Any]:
    """StarCoder2's layout is llama's but for the non-gated MLP's names:
    ``mlp.c_fc`` -> ``up_proj``, ``mlp.c_proj`` -> ``down_proj``."""
    return {k.replace(".mlp.c_fc.", ".mlp.up_proj.").replace(".mlp.c_proj.", ".mlp.down_proj."): v
            for k, v in sd.items()}


def translate_imagegpt_state_dict(sd: dict[str, Any]) -> dict[str, Any]:
    """ImageGPT's layout is GPT-2's, but its head is untied (``vocab_size -
    1`` outputs): ``lm_head`` is kept where GPT-2's translator drops it."""
    out = translate_gpt2_state_dict({k: v for k, v in sd.items() if not k.startswith("lm_head.")})
    out.update({k: v for k, v in sd.items() if k.startswith("lm_head.")})
    return out


def _renamed(sd: dict[str, Any], names: tuple, drop: tuple = ()) -> dict[str, Any]:
    """``sd`` with each (theirs, ours) of ``names`` replaced in its keys, in
    order, and the keys ending in one of ``drop`` left out."""
    out: dict[str, Any] = {}
    for k, v in sd.items():
        if k.endswith(drop):
            continue
        for old, new in names:
            k = k.replace(old, new)
        out[k] = v
    return out


# GPT-J's and CodeGen's names: ``ln_1``, the one norm of the parallel block,
# ``attn.out_proj``, ``mlp.fc_in`` / ``mlp.fc_out``; the biased lm_head
# keeps its name
_GPTJ_NAMES = (("transformer.wte.", "model.embed_tokens."), ("transformer.ln_f.", "model.norm."),
               ("transformer.h.", "model.layers."), (".ln_1.", ".input_layernorm."),
               (".attn.q_proj.", ".self_attn.q_proj."), (".attn.k_proj.", ".self_attn.k_proj."),
               (".attn.v_proj.", ".self_attn.v_proj."), (".attn.out_proj.", ".self_attn.o_proj."),
               (".mlp.fc_in.", ".mlp.up_proj."), (".mlp.fc_out.", ".mlp.down_proj."))


def translate_gptj_state_dict(sd: dict[str, Any]) -> dict[str, Any]:
    """GPT-J's layout: separate projections renamed (``_GPTJ_NAMES``), the
    causal-mask buffers dropped, the biased ``lm_head`` passed through."""
    return _renamed(sd, _GPTJ_NAMES, drop=(".attn.bias", ".attn.masked_bias"))


def make_codegen_translator(hf_cfg: dict[str, Any]) -> KeyTranslator:
    """CodeGen's layout: ``attn.qkv_proj`` fuses q/k/v over ``mp_num`` = 4
    model-parallel shards, rows [shard 0: q v k][shard 1: q v k]..., each
    part ``n_embd / 4`` rows (note the value before the key); each
    projection's shard slices, concatenated, give its rows in head order.
    The rest is GPT-J's names; the causal-mask buffer is dropped."""
    dim, mp_num = int(hf_cfg["n_embd"]), 4
    local = dim // mp_num

    def translate(sd: dict[str, Any]) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for k, v in _renamed(sd, _GPTJ_NAMES, drop=(".attn.causal_mask",)).items():
            if ".attn.qkv_proj." not in k:
                out[k] = v
                continue
            stem, leaf = k.split(".attn.qkv_proj.")
            w = v.reshape(mp_num, 3 * local, *v.shape[1:])
            for i, name in enumerate(("q_proj", "v_proj", "k_proj")):
                out[f"{stem}.self_attn.{name}.{leaf}"] = w[:, i * local:(i + 1) * local].reshape(
                    dim, *v.shape[1:])
        return out

    return translate


def translate_gpt_neo_state_dict(sd: dict[str, Any]) -> dict[str, Any]:
    """GPT-Neo's layout: plain Linears (no Conv1D transpose) under
    ``attn.attention.{q,k,v,out}_proj`` -> ``self_attn``, ``ln_1`` / ``ln_2``,
    ``mlp.c_fc`` / ``mlp.c_proj`` -> up / down, ``wte`` / ``wpe``, ``ln_f``;
    the mask buffers are dropped."""
    return _renamed(sd, (
        ("transformer.wte.", "model.embed_tokens."), ("transformer.wpe.", "model.pos_embed."),
        ("transformer.ln_f.", "model.norm."), ("transformer.h.", "model.layers."),
        (".ln_1.", ".input_layernorm."), (".ln_2.", ".post_attention_layernorm."),
        (".attn.attention.out_proj.", ".self_attn.o_proj."), (".attn.attention.", ".self_attn."),
        (".mlp.c_fc.", ".mlp.up_proj."), (".mlp.c_proj.", ".mlp.down_proj.")),
        drop=(".attn.bias", ".attn.masked_bias"))


def make_gpt_bigcode_translator(hf_cfg: dict[str, Any]) -> KeyTranslator:
    """GPTBigCode's (StarCoder's) layout: GPT-2's names on plain Linears
    (no transpose), the multi-query ``attn.c_attn`` packing [q (n_embd) |
    k (head_dim) | v (head_dim)] rows, split onto q/k/v; the mask buffers
    and the tied ``lm_head`` are dropped."""
    dim = int(hf_cfg["n_embd"])
    hd = dim // int(hf_cfg["n_head"])

    def translate(sd: dict[str, Any]) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for k, v in _renamed(sd, (
                ("transformer.wte.", "model.embed_tokens."), ("transformer.wpe.", "model.pos_embed."),
                ("transformer.ln_f.", "model.norm."), ("transformer.h.", "model.layers."),
                (".ln_1.", ".input_layernorm."), (".ln_2.", ".post_attention_layernorm."),
                (".attn.c_proj.", ".self_attn.o_proj."), (".mlp.c_fc.", ".mlp.up_proj."),
                (".mlp.c_proj.", ".mlp.down_proj.")),
                drop=(".attn.bias", ".attn.masked_bias")).items():
            if k == "lm_head.weight":
                continue
            if ".attn.c_attn." not in k:
                out[k] = v
                continue
            stem, leaf = k.split(".attn.c_attn.")
            for name, part in zip(("q_proj", "k_proj", "v_proj"),
                                  (v[:dim], v[dim:dim + hd], v[dim + hd:])):
                out[f"{stem}.self_attn.{name}.{leaf}"] = part
        return out

    return translate


# OPT's layer names, which BioGPT and XGLM share: ``self_attn.out_proj``, the
# per-layer ``self_attn_layer_norm`` / ``final_layer_norm`` (before the MLP)
# and ``fc1`` / ``fc2``
_OPT_LAYER_NAMES = ((".self_attn.out_proj.", ".self_attn.o_proj."),
                    (".self_attn_layer_norm.", ".input_layernorm."),
                    (".final_layer_norm.", ".post_attention_layernorm."),
                    (".fc1.", ".mlp.up_proj."), (".fc2.", ".mlp.down_proj."))


def translate_opt_state_dict(sd: dict[str, Any]) -> dict[str, Any]:
    """OPT's layout: ``embed_positions`` holds two leading rows for torch's
    legacy +2 offset (HF adds 2 to every position), dropped so that the
    model's absolute positions index the same rows; the per-layer
    ``self_attn_layer_norm`` / ``final_layer_norm`` (before the MLP) ->
    the input / post-attention norms, the decoder's ``final_layer_norm`` ->
    ``model.norm``, ``fc1`` / ``fc2`` -> up / down; the tied ``lm_head`` is
    dropped."""
    out: dict[str, Any] = {}
    for k, v in _renamed(sd, (
            ("model.decoder.embed_tokens.", "model.embed_tokens."),
            ("model.decoder.embed_positions.", "model.pos_embed."),
            ("model.decoder.final_layer_norm.", "model.norm."),
            ("model.decoder.layers.", "model.layers."), *_OPT_LAYER_NAMES)).items():
        if k != "lm_head.weight":
            out[k] = v[2:] if k.startswith("model.pos_embed.") else v
    return out


def make_bloom_translator(hf_cfg: dict[str, Any]) -> KeyTranslator:
    """BLOOM's layout: ``self_attention.query_key_value`` fused a head at a
    time as GPT-NeoX's (``BloomAttention._reshape``'s (heads, 3, head_dim)
    view), ``word_embeddings`` / ``word_embeddings_layernorm`` ->
    ``embed_tokens`` / ``embed_norm``, ``h`` -> ``layers``,
    ``self_attention.dense`` -> ``o_proj``, ``dense_h_to_4h`` /
    ``dense_4h_to_h`` -> up / down, ``ln_f`` -> ``model.norm``; the tied
    ``lm_head`` is dropped."""
    n_heads = int(hf_cfg.get("n_head", hf_cfg.get("num_attention_heads", 0)))
    hd = int(hf_cfg.get("hidden_size", hf_cfg.get("n_embed", 0))) // n_heads

    def translate(sd: dict[str, Any]) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for k, v in _renamed(sd, (
                ("transformer.word_embeddings_layernorm.", "model.embed_norm."),
                ("transformer.word_embeddings.", "model.embed_tokens."),
                ("transformer.ln_f.", "model.norm."), ("transformer.h.", "model.layers."),
                (".self_attention.dense.", ".self_attn.o_proj."),
                (".mlp.dense_h_to_4h.", ".mlp.up_proj."),
                (".mlp.dense_4h_to_h.", ".mlp.down_proj."))).items():
            if k == "lm_head.weight":
                continue
            if ".self_attention.query_key_value." in k:
                _split_per_head_qkv(*k.split(".self_attention.query_key_value."), v, n_heads, hd,
                                    out)
            else:
                out[k] = v
        return out

    return translate


def make_mpt_translator(hf_cfg: dict[str, Any]) -> KeyTranslator:
    """MPT's layout: ``attn.Wqkv`` stacks [q (d_model) | k | v] rows, k and
    v ``kv_n_heads`` heads each, cut at those widths; ``wte`` ->
    ``embed_tokens``, ``blocks`` -> ``layers``, ``norm_1`` / ``norm_2`` ->
    the input and post-attention norms, ``attn.out_proj`` -> ``o_proj``,
    ``ffn.up_proj`` / ``ffn.down_proj`` -> the MLP's, ``norm_f`` ->
    ``model.norm``; the tied ``lm_head`` is dropped."""
    dim, n_heads = int(hf_cfg["d_model"]), int(hf_cfg["n_heads"])
    kv_dim = dim // n_heads * int(hf_cfg.get("attn_config", {}).get("kv_n_heads", n_heads))

    def translate(sd: dict[str, Any]) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for k, v in _renamed(sd, (
                ("transformer.wte.", "model.embed_tokens."), ("transformer.norm_f.", "model.norm."),
                ("transformer.blocks.", "model.layers."), (".norm_1.", ".input_layernorm."),
                (".norm_2.", ".post_attention_layernorm."),
                (".attn.out_proj.", ".self_attn.o_proj."), (".ffn.", ".mlp."))).items():
            if k == "lm_head.weight":
                continue
            if ".attn.Wqkv." not in k:
                out[k] = v
                continue
            stem, leaf = k.split(".attn.Wqkv.")
            for name, part in zip(("q_proj", "k_proj", "v_proj"),
                                  (v[:dim], v[dim:dim + kv_dim], v[dim + kv_dim:])):
                out[f"{stem}.self_attn.{name}.{leaf}"] = part
        return out

    return translate


def translate_xglm_state_dict(sd: dict[str, Any]) -> dict[str, Any]:
    """XGLM's layout: OPT's layer names (``_OPT_LAYER_NAMES``), the
    decoder's ``layer_norm`` -> ``model.norm``; its sinusoids have no
    weight; the tied ``lm_head`` is dropped."""
    return {k: v for k, v in _renamed(sd, (("model.layer_norm.", "model.norm."),
                                           *_OPT_LAYER_NAMES)).items() if k != "lm_head.weight"}


def translate_biogpt_state_dict(sd: dict[str, Any]) -> dict[str, Any]:
    """BioGPT's layout: OPT's under ``biogpt.``, its position table's two
    offset rows dropped as OPT's, the decoder's ``layer_norm`` ->
    ``model.norm``; the tied ``output_projection`` is dropped."""
    out: dict[str, Any] = {}
    for k, v in _renamed(sd, (
            ("biogpt.embed_positions.", "model.pos_embed."), ("biogpt.layer_norm.", "model.norm."),
            ("biogpt.", "model."), *_OPT_LAYER_NAMES)).items():
        if k != "output_projection.weight":
            out[k] = v[2:] if k.startswith("model.pos_embed.") else v
    return out


def translate_ctrl_state_dict(sd: dict[str, Any]) -> dict[str, Any]:
    """CTRL's layout: ``transformer.w`` -> ``embed_tokens``,
    ``multi_head_attention.{Wq,Wk,Wv,dense}`` -> q / k / v / o, the ``ffn``
    Sequential's ``0`` / ``2`` -> up / down, ``layernorm1`` / ``layernorm2``
    -> the input and post-attention norms, ``transformer.layernorm`` ->
    ``model.norm``; the tied head keeps only its bias, as
    ``tied_head_bias``."""
    out: dict[str, Any] = {}
    for k, v in _renamed(sd, (
            ("transformer.w.", "model.embed_tokens."), ("transformer.layernorm.", "model.norm."),
            ("transformer.h.", "model.layers."), (".multi_head_attention.Wq.", ".self_attn.q_proj."),
            (".multi_head_attention.Wk.", ".self_attn.k_proj."),
            (".multi_head_attention.Wv.", ".self_attn.v_proj."),
            (".multi_head_attention.dense.", ".self_attn.o_proj."),
            (".layernorm1.", ".input_layernorm."), (".layernorm2.", ".post_attention_layernorm."),
            (".ffn.0.", ".mlp.up_proj."), (".ffn.2.", ".mlp.down_proj."),
            ("lm_head.bias", "tied_head_bias"))).items():
        if k != "lm_head.weight":
            out[k] = v
    return out


def translate_xlm_state_dict(sd: dict[str, Any]) -> dict[str, Any]:
    """XLM's (causal) layout: ``embeddings`` / ``position_embeddings`` /
    ``layer_norm_emb`` -> ``embed_tokens`` / ``pos_embed`` / ``embed_norm``,
    the per-layer lists ``attentions.N.{q,k,v,out}_lin``, ``layer_norm1.N``
    / ``layer_norm2.N`` (after each residual add) and ``ffns.N.lin1`` /
    ``lin2`` onto the layer tree, ``pred_layer.proj``'s bias ->
    ``tied_head_bias`` (its weight is the tied embedding); the language
    table is dropped (a causal LM's forward passes no languages)."""
    lists = (("attentions", "self_attn"), ("layer_norm1", "input_layernorm"),
             ("layer_norm2", "post_attention_layernorm"), ("ffns", "mlp"))
    out: dict[str, Any] = {}
    for k, v in sd.items():
        if k.startswith("transformer.lang_embeddings.") or k == "pred_layer.proj.weight":
            continue
        for theirs, ours in lists:
            if k.startswith(f"transformer.{theirs}."):
                layer, rest = k[len(f"transformer.{theirs}."):].split(".", 1)
                k = f"model.layers.{layer}.{ours}.{rest}"
                break
        for old, new in (("transformer.embeddings.", "model.embed_tokens."),
                         ("transformer.position_embeddings.", "model.pos_embed."),
                         ("transformer.layer_norm_emb.", "model.embed_norm."),
                         ("pred_layer.proj.bias", "tied_head_bias"),
                         (".self_attn.q_lin.", ".self_attn.q_proj."),
                         (".self_attn.k_lin.", ".self_attn.k_proj."),
                         (".self_attn.v_lin.", ".self_attn.v_proj."),
                         (".self_attn.out_lin.", ".self_attn.o_proj."),
                         (".mlp.lin1.", ".mlp.up_proj."), (".mlp.lin2.", ".mlp.down_proj.")):
            k = k.replace(old, new)
        out[k] = v
    return out


def make_gpt_neox_japanese_translator(hf_cfg: dict[str, Any]) -> KeyTranslator:
    """GPT-NeoX-Japanese's layout: the bias-free ``attention.query_key_value``
    fused a head at a time (GPT-NeoX's split), ``attention.dense`` ->
    ``o_proj``, whose bias the checkpoint holds as ``attention.dense_bias``
    on the last layer only: every other layer's is zero-filled (HF's module
    has none there); ``embed_in`` / ``embed_out`` / ``final_layer_norm``
    and the MLP's ``dense_*`` renamed; the rotary buffers dropped."""
    n_heads, dim = int(hf_cfg["num_attention_heads"]), int(hf_cfg["hidden_size"])
    n_layers = int(hf_cfg["num_hidden_layers"])

    def translate(sd: dict[str, Any]) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for k, v in _renamed(sd, (
                ("gpt_neox_japanese.embed_in.", "model.embed_tokens."),
                ("gpt_neox_japanese.final_layer_norm.", "model.norm."),
                ("gpt_neox_japanese.layers.", "model.layers."), ("embed_out.", "lm_head."),
                (".attention.dense_bias", ".self_attn.o_proj.bias"),
                (".attention.dense.", ".self_attn.o_proj."),
                (".mlp.dense_h_to_4h.", ".mlp.up_proj."), (".mlp.dense_4h_to_h.", ".mlp.down_proj.")),
                drop=("rotary_emb.inv_freq",)).items():
            if ".attention.query_key_value." in k:
                _split_per_head_qkv(*k.split(".attention.query_key_value."), v, n_heads,
                                    dim // n_heads, out)
            else:
                out[k] = v
        like = out.get(f"model.layers.{n_layers - 1}.self_attn.o_proj.bias", torch.zeros(dim))
        for i in range(n_layers - 1):
            out.setdefault(f"model.layers.{i}.self_attn.o_proj.bias",
                           np.zeros_like(like) if isinstance(like, np.ndarray)
                           else torch.zeros_like(like))
        return out

    return translate


def translate_doge_state_dict(sd: dict[str, Any]) -> dict[str, Any]:
    """Doge's layout: the dynamic-mask parameter ``self_attn.A`` ->
    ``self_attn.dyn_mask_A``; ``dt_proj``, the q/k norms and the residual
    scales keep HF's names."""
    return {(k[: -len(".self_attn.A")] + ".self_attn.dyn_mask_A"
             if k.endswith(".self_attn.A") else k): v for k, v in sd.items()}


def translate_moshi_state_dict(sd: dict[str, Any]) -> dict[str, Any]:
    """Moshi's temporal transformer: the attention projections' ``.linear``
    nesting unwrapped, the fused gating ``mlp.fc1`` split in halves into
    [gate | up], ``mlp.fc2`` -> ``down_proj``; a full checkpoint's depth
    decoder and audio encoder dropped."""
    out: dict[str, Any] = {}
    for k, v in sd.items():
        if k.startswith(("depth_decoder.", "audio_encoder.")):
            continue
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            k = k.replace(f".self_attn.{proj}.linear.", f".self_attn.{proj}.")
        if ".mlp.fc1." in k:
            stem, leaf = k.split(".mlp.fc1.")
            half = v.shape[0] // 2
            out[f"{stem}.mlp.gate_proj.{leaf}"] = v[:half]
            out[f"{stem}.mlp.up_proj.{leaf}"] = v[half:]
            continue
        out[k.replace(".mlp.fc2.", ".mlp.down_proj.")] = v
    return out


def make_mllama_translator(hf_cfg: dict[str, Any]) -> KeyTranslator:
    """Mllama's text path (a full mllama snapshot or its text model):
    ``model.language_model.`` -> ``model.`` and a leading
    ``language_model.`` stripped, the vision tower and projector dropped,
    and every weight of a cross-attention layer dropped (those layers are
    ``SkipBlock``s, which keep the numbering)."""
    inner = dict(hf_cfg.get("text_config") or hf_cfg)
    cross = {int(i) for i in inner.get("cross_attention_layers") or ()}

    def translate(sd: dict[str, Any]) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for k, v in sd.items():
            if k.startswith(("vision_model.", "multi_modal_projector.")):
                continue
            k = k.replace("model.language_model.", "model.").removeprefix("language_model.")
            parts = k.split(".")
            if len(parts) > 2 and parts[:2] == ["model", "layers"] and int(parts[2]) in cross:
                continue
            out[k] = v
        return out

    return translate


def translate_deepseek_state_dict(sd: dict[str, Any]) -> dict[str, Any]:
    """HF DeepSeek-V2 / V3 (JAX hf_loader.py:147-170): the ungated shared
    experts ``mlp.shared_experts.`` -> ``mlp.shared_expert.`` and the V3
    router's selection bias ``mlp.gate.e_score_correction_bias`` -> the
    ``mlp.gate_correction_bias`` leaf; the latent-attention projections and
    the experts keep their names."""
    out = {}
    for k, v in sd.items():
        if ".mlp.shared_experts." in k:
            k = k.replace(".mlp.shared_experts.", ".mlp.shared_expert.")
        elif k.endswith(".mlp.gate.e_score_correction_bias"):
            k = k.replace(".mlp.gate.e_score_correction_bias", ".mlp.gate_correction_bias")
        out[k] = v
    return out


# model types whose HF names are the port model's own
_SAME_NAMES = (
    "llama", "code_llama", "mistral", "ministral", "qwen2", "qwen3", "gemma", "gemma2",
    "gemma3_text", "olmo2", "olmo3", "smollm3", "phi", "stablelm", "granite", "cohere", "emu3",
    "emu3_text_model", "olmo", "nemotron", "ernie4_5", "arcee", "seed_oss", "exaone4", "helium",
    "cohere2", "bitnet", "diffllama", "qwen2_moe", "qwen3_moe", "olmoe", "flex_olmo",
)


# the translator of every other layout; each of ``_MADE_FROM_CONFIG`` makes
# it from the config (phi3's, GPT-NeoX's, Falcon's, CodeGen's, GPTBigCode's
# and Persimmon's splits take its widths, the wrappers' text path its type)
_TRANSLATORS = {
    "glm": translate_glm_state_dict, "glm4": translate_glm4_state_dict,
    "gpt2": translate_gpt2_state_dict, "openai-gpt": translate_gpt2_state_dict,
    "gpt-sw3": translate_gpt2_state_dict, "starcoder2": translate_starcoder2_state_dict,
    "imagegpt": translate_imagegpt_state_dict, "gptj": translate_gptj_state_dict,
    "gpt_neo": translate_gpt_neo_state_dict, "opt": translate_opt_state_dict,
    "gpt_neox": make_gpt_neox_translator, "falcon": make_falcon_translator,
    "codegen": make_codegen_translator, "gpt_bigcode": make_gpt_bigcode_translator,
    "persimmon": make_persimmon_translator, "fuyu": make_multimodal_text_translator,
    "vaultgemma": translate_vaultgemma_state_dict, "apertus": translate_apertus_state_dict,
    "hunyuan_v1_dense": translate_hunyuan_state_dict,
    "open-llama": translate_open_llama_state_dict, "bloom": make_bloom_translator,
    "mpt": make_mpt_translator, "xglm": translate_xglm_state_dict,
    "biogpt": translate_biogpt_state_dict, "ctrl": translate_ctrl_state_dict,
    "xlm": translate_xlm_state_dict, "gpt_neox_japanese": make_gpt_neox_japanese_translator,
    "doge": translate_doge_state_dict, "moshi": translate_moshi_state_dict,
    "mllama": make_mllama_translator, "mllama_text_model": make_mllama_translator,
    "deepseek_v2": translate_deepseek_state_dict, "deepseek_v3": translate_deepseek_state_dict,
    "got_ocr2": make_multimodal_text_translator, "mixtral": translate_mixtral_state_dict,
    "phi3": _phi3_translator, "gemma3": make_multimodal_text_translator,
}
_MADE_FROM_CONFIG = (_phi3_translator, make_gpt_neox_translator, make_falcon_translator,
                     make_codegen_translator, make_gpt_bigcode_translator,
                     make_persimmon_translator, make_multimodal_text_translator,
                     make_bloom_translator, make_mpt_translator,
                     make_gpt_neox_japanese_translator, make_mllama_translator)


def translator_for(hf_cfg: dict[str, Any]) -> Optional[KeyTranslator]:
    """The checkpoint-layout translator for a config's ``model_type``: None
    where HF's names are the model's already.  Raises for a model type the
    port has no model for (ROADMAP.md lists them)."""
    mt = hf_cfg.get("model_type")
    if mt in _SAME_NAMES:
        return None
    if mt not in _TRANSLATORS:
        *names, last = (*_SAME_NAMES, *_TRANSLATORS)
        raise ValueError(f"model_type={mt!r}: the port has models for {', '.join(names)} and "
                         f"{last} only; the other families wait in ROADMAP.md")
    translate = _TRANSLATORS[mt]
    return translate(hf_cfg) if translate in _MADE_FROM_CONFIG else translate
