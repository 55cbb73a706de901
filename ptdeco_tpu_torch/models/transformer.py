"""Decoder-only causal LM, llama family, its MoE decoders and the families
beyond the llama graph that the port has, in PyTorch.

Counterpart of the llama-family, Mixtral, Qwen2-/Qwen3-MoE, OLMoE,
FlexOlmo, DeepSeek-V2 / V3 and gpt2 / gpt_neox / falcon /
starcoder2 / stablelm / granite / cohere / gptj / codegen / gpt_neo /
gpt_bigcode / opt / openai-gpt / imagegpt / olmo / nemotron / persimmon /
ernie4_5 / arcee / seed_oss / exaone4 / vaultgemma / apertus /
hunyuan_v1_dense / helium / open-llama / cohere2 / gpt_neox_japanese /
biogpt / xlm / bitnet / xglm / ctrl / bloom / mpt parts of
``ptdeco_tpu/models/transformer.py``: RMSNorm (optionally the gemma (1 + w)
flavour) or LayerNorm (optionally without its offset, without any affine as
OLMo's, or Nemotron's (1 + w)), HF rotate-half rope
at absolute positions (optionally with llama3, yarn, linear or phi3's
short-factor longrope scaling, over only the leading dims of each head and
pair-interleaved as GLM's, or left out per layer as SmolLM3's NoPE
layers), grouped-query attention (optionally with
Qwen2's and GLM's q/k/v biases, Qwen3's and Gemma-3's per-head q/k RMSNorm,
OLMo-2's q/k RMSNorm over the whole projection and its ``clip_qkv`` clamp,
Persimmon's per-head q/k LayerNorm, Gemma-2's logit soft-cap and query
scale, and the sliding-window layers of
Gemma-3, OLMo-3 and Ministral with Gemma-3's and OLMo-3's local rope, or
no rotary at all, or BLOOM's and MPT's ALiBi; BitNet's RMSNorm over the
merged heads), a gated MLP (SwiGLU, or gemma's tanh-GELU) or a
non-gated one (exact or tanh GELU, relu, relu^2, Apertus's xIELU with its
learned scalars; BitNet's RMSNorm over the activation product), the
top-k routed mixture
of SwiGLU experts (``MoEMLP``, on the sparse layers; Qwen2-MoE's
sigmoid-gated shared expert beside it, DeepSeek's sigmoid, bias-corrected,
group-limited and scaled routing with its ungated shared expert),
DeepSeek's multi-head latent attention (``MLAttention``), pre-norm blocks (the sandwich norms of
Gemma-2, Gemma-3 and GLM-4, OLMo-2's post-norm-only blocks, the one-norm
and two-norm parallel residuals of GPT-NeoX, Falcon, Cohere and GPT-J,
Granite's scaled residuals, GPT-1's post-LN blocks; optionally each under
``torch.utils.checkpoint``, the config's ``remat``), an embedding
optionally scaled by sqrt(dim) (gemma) or Granite's multiplier, with
GPT-2's learned positions added (ImageGPT's with one more row than the
head has outputs) or XGLM's and CTRL's computed sinusoids, and
open-llama's, BLOOM's and XLM's LayerNorm over it, no final norm for GPT-1
and XLM, and a dict-in/logits-out
``CausalLM`` (optionally scaling and soft-capping its logits, with GPT-J's
biased head).
Every projection is an ``nn.Linear`` site and parameter names follow HF
llama and the JAX package's MoE layout
(``model.layers.0.self_attn.q_proj.weight``,
``model.layers.0.mlp.experts.3.down_proj.weight``), so decompose configs
and state dicts line up with the JAX package and with HF checkpoints.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..ops.flash_attention import KERNEL_HEAD_DIMS, causal_attention_plain, flash_attention
from ..ops.gmm import grouped_matmul, grouped_matmul_plain
from ..ops.gmm_int8 import grouped_matmul_int8
from ..quant import QuantLinear

__all__ = [
    "TransformerConfig",
    "RMSNorm",
    "LayerNorm",
    "Attention",
    "DiffAttention",
    "MLAttention",
    "MLP",
    "MoEMLP",
    "Block",
    "SkipBlock",
    "PrunedSublayer",
    "prune_blocks",
    "Decoder",
    "CausalLM",
    "ce_loss",
    "router_scores",
    "moe_combine_weights",
    "HF_FAMILIES",
    "WRAPPED_TEXT_TYPES",
]

logger = logging.getLogger(__name__)


# the HF model types ``TransformerConfig.from_hf_config`` builds (gemma3,
# got_ocr2, emu3, fuyu and mllama are multimodal wrappers, whose text paths
# are gemma3_text, qwen2, emu3_text_model (the llama graph over multimodal
# tokens), persimmon and mllama_text_model; code_llama and gpt-sw3 are llama's and gpt2's
# graphs under other names, ``_ALIASES``; the types from gpt2 on build
# through their own constructors, ``_BEYOND_LLAMA``)
HF_FAMILIES = (
    "llama", "mistral", "qwen2", "qwen3", "gemma", "mixtral", "gemma2", "gemma3_text", "gemma3",
    "phi3", "olmo2", "olmo3", "smollm3", "glm", "glm4", "ministral", "code_llama", "got_ocr2",
    "emu3", "emu3_text_model",
    "gpt2", "gpt-sw3", "gpt_neox", "falcon", "starcoder2", "stablelm", "granite", "cohere",
    "gptj", "codegen", "gpt_neo", "gpt_bigcode", "opt", "openai-gpt", "imagegpt",
    "olmo", "nemotron", "persimmon", "fuyu", "ernie4_5", "arcee", "seed_oss", "exaone4",
    "vaultgemma", "apertus", "hunyuan_v1_dense", "helium", "open-llama",
    "cohere2", "gpt_neox_japanese", "biogpt", "xlm", "bitnet", "xglm", "ctrl", "bloom", "mpt",
    "doge", "diffllama", "mllama", "mllama_text_model", "moshi",
    "qwen2_moe", "qwen3_moe", "olmoe", "flex_olmo", "deepseek_v2", "deepseek_v3",
)
# the text path's model type of each multimodal wrapper
WRAPPED_TEXT_TYPES = {"gemma3": "gemma3_text", "got_ocr2": "qwen2", "emu3": "emu3_text_model",
                      "fuyu": "persimmon", "mllama": "mllama_text_model"}
# model types that HF maps onto another type's config and model classes
_ALIASES = {"code_llama": "llama", "gpt-sw3": "gpt2"}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    dim: int = 2048
    n_layers: int = 22
    n_heads: int = 32
    n_kv_heads: int = 4
    hidden_dim: int = 5632
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    qkv_bias: bool = False  # Qwen2: biases on q/k/v, added before rope
    tie_embeddings: bool = False
    # gemma (HF GemmaConfig): an explicit head_dim (gemma-7b has
    # n_heads * head_dim != dim), the tanh-GELU MLP, the embedding scaled
    # by sqrt(dim), and the (1 + w) RMSNorm
    head_dim_override: Optional[int] = None
    # "silu" | "gelu_tanh" | "gelu_exact" | "relu" | "quick_gelu" | "relu2" | "xielu"
    mlp_act: str = "silu"
    scale_embeddings: bool = False
    norm_plus_one: bool = False
    # Qwen3 and Gemma-3: a per-head RMSNorm on q and k before rope;
    # qk_norm_type "layernorm" makes it a per-head LayerNorm with a bias
    # (Persimmon's qk_layernorm)
    qk_norm: bool = False
    qk_norm_type: str = "rmsnorm"  # | "layernorm"
    # OLMo-2 / OLMo-3: the q/k RMSNorms span the whole projection (all heads
    # jointly, widths n_heads * head_dim and n_kv_heads * head_dim)
    qk_norm_flat: bool = False
    # OLMo-2 / OLMo-3: no input norm; the attention and MLP outputs are
    # normed before each residual add
    post_norm_only: bool = False
    # gemma2 / gemma3: sandwich norms (the attention output normed, the MLP
    # between a pre and a post norm), tanh soft-caps of the attention and
    # final logits, and the query scale query_pre_attn_scalar ** -0.5
    sandwich_norms: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    query_scale_override: Optional[float] = None
    # llama3.1+ rope scaling: (factor, low_freq_factor, high_freq_factor,
    # original_max_position_embeddings)
    rope_llama3_scaling: Optional[tuple] = None
    # gemma3: the layers layer_types marks "sliding_attention" attend only
    # to the last sliding_window keys; attention_bias biases all four
    # projections
    sliding_window: Optional[int] = None
    layer_types: tuple = ()
    o_proj_bias: bool = False
    # precomputed rotary: (inverse frequencies as floats, attention factor),
    # cos and sin scaled by the factor; yarn, linear (inv_freq / factor,
    # factor 1) and phi3's short-factor longrope
    rope_yarn: Optional[tuple] = None
    # gemma3: sliding layers rotate at this unscaled local theta (olmo3: at
    # rope_theta, unscaled)
    rope_local_theta: Optional[float] = None
    # smollm3: rope_layers[i] == 0 leaves layer i unrotated (NoPE; empty:
    # rope everywhere)
    rope_layers: tuple = ()
    # glm / glm4: only the first int(head_dim * factor) dims of each head
    # rotate, in the pair-interleaved (GPT-J) convention
    rope_partial_factor: Optional[float] = None
    rope_interleaved: bool = False
    # olmo: q, k and v clamped to [-clip_qkv, clip_qkv] after the q/k norms
    clip_qkv: Optional[float] = None
    # the beyond-llama graphs: LayerNorm blocks (norm_bias its offset;
    # cohere's carry none); a non-gated MLP down(act(up(x))) with no
    # gate_proj (gpt2, gpt_neox, falcon, starcoder2) and biases on its
    # projections; gpt2's learned table of learned_pos absolute positions
    # added to the embedding, with no rotary; the parallel residual
    # x + attn(ln1 x) + mlp(mlp_in), mlp_in ln2 x ("two_norm": gpt_neox,
    # falcon's new architecture) or the shared ln1 x ("one_norm": falcon-7b,
    # cohere); granite's embedding and residual multipliers; a scale on the
    # logits (cohere's logit_scale, granite's 1 / logits_scaling)
    norm_type: str = "rmsnorm"  # | "layernorm"
    norm_bias: bool = True
    # olmo: LayerNorm blocks with no weight and no bias (OlmoLayerNorm);
    # norm_plus_one on a LayerNorm is Nemotron's LayerNorm1P, y * (w + 1) + b
    norm_no_affine: bool = False
    mlp_gated: bool = True
    mlp_bias: bool = False
    use_rope: bool = True
    learned_pos: Optional[int] = None
    parallel_residual: str = "none"  # | "two_norm" | "one_norm"
    embedding_multiplier: Optional[float] = None
    residual_multiplier: Optional[float] = None
    logit_scale: Optional[float] = None
    # gptj / codegen: the head carries a bias (a tied head a bias of its own)
    lm_head_bias: bool = False
    # openai-gpt (GPT-1): post-LN blocks (each norm after its residual add)
    # and no final norm
    post_ln: bool = False
    final_norm: bool = True
    # imagegpt: the embedding holds this many rows, the head vocab_size
    # outputs
    embed_vocab_size: Optional[int] = None
    # open-llama, bloom, xlm: a LayerNorm (its offset by norm_bias) over
    # the embedding (after any position add) before the first block
    embed_norm: bool = False
    # bloom / mpt: ALiBi, slope_h * key position added to head h's scaled
    # f32 logits (no rotary, no position table)
    use_alibi: bool = False
    # bitnet: RMSNorms over the merged heads before o_proj (attn_sub_norm)
    # and over the activation product before down_proj (ffn_sub_norm)
    sub_norms: bool = False
    # xglm / ctrl: a computed sinusoid table (sin | cos halves, no
    # parameter) at positions + sinusoidal_offset, added to the embedding;
    # "fairseq" (xglm) spaces the frequencies by log(1e4) / (half - 1),
    # "t2t" (ctrl) by 2 log(1e4) / dim
    sinusoidal_pos: bool = False
    sinusoidal_offset: int = 2
    sinusoidal_kind: str = "fairseq"  # | "t2t"
    # diffllama: differential attention (``DiffAttention``): one softmax
    # over all heads, the two halves' value-weighted outputs subtracted with
    # a learned, layer-indexed lambda over paired 2 * head_dim values
    diff_attention: bool = False
    # doge: the per-kv-head additive key bias exp(A * softplus(dt_proj(v)))
    # on the scaled f32 logits, exact for sequences up to keep_window_size
    # (its top-k masking beyond the window is refused)
    dyn_mask_keep_window: Optional[int] = None
    # doge: learned per-channel vectors scaling the residual term of each
    # add (``Block.input_residual`` / ``post_attention_residual``)
    residual_scales: bool = False
    dtype: torch.dtype = torch.float32
    # Mixture of experts (Mixtral, Qwen2-MoE, Qwen3-MoE, OLMoE, FlexOlmo):
    # n_experts > 0 replaces the MLP of each sparse layer with a top-k
    # routed MoEMLP of SwiGLU experts of width moe_hidden_dim (hidden_dim
    # where None); layer i is sparse iff i is not in mlp_only_layers and
    # (i + 1) % decoder_sparse_step == 0 (HF Qwen3-MoE's rule; Mixtral's
    # every layer), the others keep the dense MLP at hidden_dim.  The top-k
    # weights are renormalized with norm_topk_prob.  Qwen2-MoE adds an
    # always-on shared expert of width shared_expert_hidden_dim, scaled by
    # sigmoid(shared_expert_gate(x)) where shared_expert_gated
    n_experts: int = 0
    n_experts_per_tok: int = 2
    norm_topk_prob: bool = True
    moe_hidden_dim: Optional[int] = None
    mlp_only_layers: tuple = ()
    decoder_sparse_step: int = 1
    shared_expert_hidden_dim: Optional[int] = None
    shared_expert_gated: bool = True
    # DeepSeek-V2 / V3 multi-head latent attention: kv_lora_rank set makes
    # every block's mixer an ``MLAttention`` (a kv_lora_rank latent and one
    # shared rope head per token, expanded per head by kv_b_proj);
    # q_lora_rank None is a direct q_proj (V2-Lite).  mla_softmax_scale
    # multiplies qk_head^-0.5 (yarn's mscale^2)
    q_lora_rank: Optional[int] = None
    kv_lora_rank: Optional[int] = None
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128
    mla_softmax_scale: Optional[float] = None
    # DeepSeek's routing on the MoE fields above: sigmoid or softmax scores,
    # a selection-only correction bias (``MoEMLP.gate_correction_bias``),
    # group-limited choice (the best router_topk_group of router_n_group
    # groups, scored by their max or, router_group_top2_sum, their top-2
    # sum) and a scale on the combine weights
    router_score_func: str = "softmax"  # | "sigmoid"
    router_n_group: int = 0  # 0: no group limit
    router_topk_group: int = 0
    router_group_top2_sum: bool = False
    router_correction_bias: bool = False
    routed_scaling_factor: float = 1.0
    # per-block gradient checkpointing (the JAX package's remat): each
    # block's activations are recomputed in the backward pass
    remat: bool = False

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.dim // self.n_heads

    def layer_is_sparse(self, layer_idx: int) -> bool:
        """Whether layer ``layer_idx``'s MLP is a ``MoEMLP`` (the JAX
        package's ``_layer_is_sparse``)."""
        return (self.n_experts > 0 and layer_idx not in self.mlp_only_layers
                and (layer_idx + 1) % self.decoder_sparse_step == 0)

    @staticmethod
    def from_hf_config(
        hf: dict[str, Any], dtype: torch.dtype = torch.bfloat16, remat: bool = False
    ) -> "TransformerConfig":
        """HF ``config.json`` of a llama (or code_llama), mistral, qwen2,
        qwen3, gemma, gemma2, gemma3_text, phi3, olmo2, olmo3, smollm3, glm,
        glm4, ministral, mixtral, qwen2_moe, qwen3_moe, olmoe, flex_olmo,
        deepseek_v2 or deepseek_v3 checkpoint, or of the gemma3, got_ocr2 or
        emu3 wrapper (its text_config) -> config, as the JAX package's
        family branch builds it; a gpt2 (or gpt-sw3), gpt_neox, falcon,
        starcoder2, stablelm, granite, cohere, gptj, codegen, gpt_neo,
        gpt_bigcode, opt, openai-gpt, imagegpt, olmo, nemotron, persimmon
        (or the fuyu wrapper), ernie4_5, arcee, seed_oss, exaone4,
        vaultgemma, apertus, hunyuan_v1_dense, helium, open-llama, cohere2,
        gpt_neox_japanese, biogpt, xlm, bitnet, xglm, ctrl, bloom, mpt, doge,
        diffllama, mllama_text_model (or the mllama wrapper) or moshi one
        through that family's own constructor, as the JAX package's
        ``beyond_llama`` table does.
        Raises ValueError on
        anything these families do not express here (rope types other than
        llama3 / yarn / linear, phi3's partial rotary, other bias layouts,
        the JAX constructors' own refusals and every other model type;
        ROADMAP.md lists them).  A ``sliding_window`` is applied per
        layer for gemma3, olmo3 and ministral; for mistral, mixtral, gemma2
        and phi3 it is logged and not applied: full causal attention, exact
        for sequences within the window."""
        mt = hf.get("model_type", "llama")
        mt = _ALIASES.get(mt, mt)
        if mt in WRAPPED_TEXT_TYPES:
            # a multimodal wrapper: the text path builds from text_config
            # (its vision tower's weights are dropped on load)
            hf = dict(hf["text_config"])
            hf.setdefault("model_type", WRAPPED_TEXT_TYPES[mt])
            mt = hf["model_type"]
        if mt not in HF_FAMILIES:
            raise ValueError(
                f"model_type={mt!r}: the port builds {list(HF_FAMILIES)} from a config.json "
                "(and phi through PhiConfig); the other families wait in ROADMAP.md"
            )
        if mt in _BEYOND_LLAMA:
            return _BEYOND_LLAMA[mt](hf, dtype, remat)
        if mt == "gemma3_text" and hf.get("use_bidirectional_attention"):
            raise ValueError(
                "gemma3 use_bidirectional_attention is not implemented (this decoder is causal)"
            )
        rs = hf.get("rope_scaling")
        deepseek = mt in ("deepseek_v2", "deepseek_v3")
        if mt == "phi3":
            if rs is not None and rs.get("rope_type", rs.get("type")) != "longrope":
                raise ValueError(
                    f"phi3 rope_scaling type {rs.get('rope_type', rs.get('type'))!r} is not "
                    "implemented"
                )
            if float(hf.get("partial_rotary_factor", 1.0)) != 1.0:
                raise ValueError(
                    "phi3 with partial_rotary_factor != 1 (Phi-4-mini) is not implemented in "
                    "the port: the JAX package's longrope frequencies do not fit its rope "
                    "then (ROADMAP.md)"
                )
        # gemma configs carry hidden_activation (the authoritative field;
        # older snapshots say hidden_act "gelu" and run the tanh form)
        act = hf.get("hidden_activation") or hf.get("hidden_act", "silu")
        act_map = {"silu": "silu", "gelu": "gelu_tanh", "gelu_pytorch_tanh": "gelu_tanh"}
        if act not in act_map:
            raise ValueError(f"Unsupported hidden_act={act!r}")
        # qwen2's and glm's layout (biases on q/k/v, none on o_proj) and
        # gemma3's (all four) are the attention biases expressed; llama /
        # mistral with attention_bias bias o_proj too, and mlp_bias biases
        # gate/up/down
        qkv_bias_types = ("qwen2", "glm", "glm4")
        if bool(hf.get("attention_bias", False)) and mt not in (*qkv_bias_types, "gemma3_text"):
            raise ValueError(
                "attention_bias=True with an o_proj bias is not expressed (only "
                "qwen2's and glm's q/k/v-bias and gemma3's layouts are); ROADMAP.md lists the "
                "other layouts"
            )
        if bool(hf.get("mlp_bias", False)):
            raise ValueError(
                "mlp_bias=True (biases on gate/up/down) is not expressed; ROADMAP.md lists it"
            )
        n_heads = int(hf["num_attention_heads"])
        dim = int(hf["hidden_size"])
        head_dim = hf.get("head_dim")
        rot_dim = int(head_dim) if head_dim is not None else dim // n_heads
        theta = float(hf.get("rope_theta", 10000.0))
        rope_llama3, rope_yarn = None, None
        if rs is not None and mt != "phi3":
            rtype = rs.get("rope_type", rs.get("type"))
            if rtype == "llama3":
                rope_llama3 = _llama3_scaling(rs)
            elif rtype == "yarn":
                # DeepSeek's decoupled rope head is the only rotated part
                yarn_dim = int(hf.get("qk_rope_head_dim", 64)) if deepseek else rot_dim
                rope_yarn = yarn_parameters(
                    yarn_dim, theta, rs, int(hf.get("max_position_embeddings", 4096))
                )
            elif rtype == "linear":
                # position interpolation: every inverse frequency divided by
                # factor, cos and sin unscaled
                factor, half = float(rs["factor"]), rot_dim // 2
                rope_yarn = (
                    tuple(float(1.0 / (theta ** (i / half) * factor)) for i in range(half)),
                    1.0,
                )
            elif rtype not in (None, "default"):
                raise ValueError(
                    f"rope_scaling type {rtype!r} is not implemented (only 'llama3', 'yarn' "
                    "and 'linear'), as in the JAX package"
                )
        elif rs is not None:
            rope_yarn = _longrope_short_factor(hf, rs, rot_dim, theta)
        # the windowed layers of gemma3, olmo3 and ministral are applied per
        # layer_types (gemma3 derives it from sliding_window_pattern where
        # absent: every pat-th layer is full)
        hybrid_sliding = mt in ("gemma3_text", "olmo3", "ministral")
        layer_types = tuple(hf.get("layer_types") or ())
        if mt == "gemma3_text" and not layer_types:
            pat = int(hf.get("sliding_window_pattern") or 6)
            layer_types = tuple(
                "full_attention" if (i + 1) % pat == 0 else "sliding_attention"
                for i in range(int(hf["num_hidden_layers"]))
            )
        sliding = hf.get("sliding_window")
        if sliding is not None and hf.get("use_sliding_window", True) and not hybrid_sliding:
            logger.info(
                "sliding_window=%s in config: full causal attention is used; keep "
                "sequences within the window for exactness", sliding,
            )
        gemma_like = mt in ("gemma", "gemma2", "gemma3_text")

        def opt_float(key: str) -> Optional[float]:
            return float(hf[key]) if hf.get(key) is not None else None

        # the MoE fields, as the JAX package's branch reads them: Mixtral
        # (HF MixtralSparseMoeBlock) always renormalizes and runs experts at
        # intermediate_size on every layer; Qwen2-/Qwen3-MoE renormalize by
        # norm_topk_prob, size experts by moe_intermediate_size and choose
        # sparse layers by decoder_sparse_step / mlp_only_layers, Qwen2-MoE
        # with its gated shared expert; OLMoE and FlexOlmo route as Mixtral
        # but renormalize by norm_topk_prob, every layer sparse; DeepSeek's
        # (``_deepseek_moe``) add their routing and latent attention
        moe: dict[str, Any] = {}
        if mt == "mixtral":
            moe = dict(n_experts=int(hf["num_local_experts"]),
                       n_experts_per_tok=int(hf.get("num_experts_per_tok", 2)))
        elif mt in ("qwen2_moe", "qwen3_moe"):
            moe = dict(
                n_experts=int(hf["num_experts"]),
                n_experts_per_tok=int(hf.get("num_experts_per_tok", 8)),
                norm_topk_prob=bool(hf.get("norm_topk_prob", False)),
                moe_hidden_dim=int(hf["moe_intermediate_size"]),
                mlp_only_layers=tuple(hf.get("mlp_only_layers") or ()),
                decoder_sparse_step=int(hf.get("decoder_sparse_step", 1)),
                shared_expert_hidden_dim=(
                    int(hf["shared_expert_intermediate_size"]) if mt == "qwen2_moe" else None),
            )
        elif mt in ("olmoe", "flex_olmo"):
            moe = dict(n_experts=int(hf["num_experts"]),
                       n_experts_per_tok=int(hf.get("num_experts_per_tok", 8)),
                       norm_topk_prob=bool(hf.get("norm_topk_prob", False)),
                       moe_hidden_dim=int(hf["intermediate_size"]))
        mla: dict[str, Any] = {}
        if deepseek:
            moe, mla = _deepseek_moe(hf, mt), _deepseek_mla(hf, rs)

        return TransformerConfig(
            vocab_size=int(hf["vocab_size"]),
            dim=dim,
            n_layers=int(hf["num_hidden_layers"]),
            n_heads=n_heads,
            n_kv_heads=int(hf.get("num_key_value_heads", n_heads)),
            hidden_dim=int(hf["intermediate_size"]),
            norm_eps=float(hf.get("rms_norm_eps", 1e-6)),
            rope_theta=theta,
            # qwen2_moe names its q/k/v-bias knob qkv_bias (its
            # attention_bias is present but null)
            qkv_bias=(bool(hf.get("qkv_bias", True)) if mt == "qwen2_moe"
                      else bool(hf.get("attention_bias", mt in qkv_bias_types))),
            tie_embeddings=bool(hf.get("tie_word_embeddings", gemma_like)),
            head_dim_override=_explicit_head_dim(hf),
            mlp_act=act_map[act],
            scale_embeddings=gemma_like,
            norm_plus_one=gemma_like,
            qk_norm=mt in ("qwen3", "qwen3_moe", "gemma3_text"),
            qk_norm_flat=mt in ("olmo2", "olmo3", "olmoe", "flex_olmo"),
            post_norm_only=mt in ("olmo2", "olmo3", "flex_olmo"),
            # glm4's block is gemma2's sandwich wiring under other checkpoint
            # names (hf_loader.translate_glm4_state_dict)
            sandwich_norms=mt in ("gemma2", "gemma3_text", "glm4"),
            attn_logit_softcap=opt_float("attn_logit_softcapping"),
            final_logit_softcap=opt_float("final_logit_softcapping"),
            query_scale_override=opt_float("query_pre_attn_scalar"),
            rope_llama3_scaling=rope_llama3,
            sliding_window=int(sliding) if hybrid_sliding and sliding else None,
            layer_types=layer_types if hybrid_sliding else (),
            o_proj_bias=bool(hf.get("attention_bias", False)) if hybrid_sliding else False,
            rope_yarn=rope_yarn,
            # olmo3's sliding layers rotate at rope_theta with the scaling
            # dropped
            rope_local_theta=(
                float(hf.get("rope_local_base_freq", 10000.0)) if mt == "gemma3_text"
                else theta if mt == "olmo3" else None
            ),
            rope_layers=(
                tuple(int(v) for v in (hf.get("no_rope_layers") or ())) if mt == "smollm3" else ()
            ),
            rope_partial_factor=(
                float(hf.get("partial_rotary_factor", 0.5)) if mt in ("glm", "glm4") else None
            ),
            # v3 configs carry rope_interleave (default true); v2's complex
            # pairs are always interleaved
            rope_interleaved=(mt in ("glm", "glm4")
                              or (deepseek and bool(hf.get("rope_interleave", True)))),
            clip_qkv=opt_float("clip_qkv"),
            dtype=dtype,
            **moe,
            **mla,
            remat=remat,
        )

    @staticmethod
    def tiny(vocab_size: int = 256, dtype: torch.dtype = torch.float32) -> "TransformerConfig":
        return TransformerConfig(
            vocab_size=vocab_size, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            hidden_dim=128, dtype=dtype,
        )

    @staticmethod
    def tinyllama_1_1b(dtype: torch.dtype = torch.bfloat16) -> "TransformerConfig":
        return TransformerConfig(
            vocab_size=32000, dim=2048, n_layers=22, n_heads=32, n_kv_heads=4,
            hidden_dim=5632, dtype=dtype,
        )

    @staticmethod
    def qwen2_1_5b(dtype: torch.dtype = torch.bfloat16) -> "TransformerConfig":
        return TransformerConfig(
            vocab_size=151936, dim=1536, n_layers=28, n_heads=12, n_kv_heads=2,
            hidden_dim=8960, qkv_bias=True, tie_embeddings=True,
            rope_theta=1000000.0, norm_eps=1e-6, dtype=dtype,
        )

    @staticmethod
    def llama3_8b(dtype: torch.dtype = torch.bfloat16) -> "TransformerConfig":
        return TransformerConfig(
            vocab_size=128256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
            hidden_dim=14336, rope_theta=500000.0, dtype=dtype,
        )


# HF activation names of the beyond-llama families (the JAX package's
# ``_hf_act``): "gelu" is the exact GELU here, unlike the llama branch's
# gemma table, where it names the tanh form
_HF_ACTS = {
    "gelu": "gelu_exact", "gelu_new": "gelu_tanh", "gelu_fast": "gelu_tanh",
    "gelu_pytorch_tanh": "gelu_tanh", "silu": "silu", "relu": "relu", "quick_gelu": "quick_gelu",
    "relu2": "relu2", "xielu": "xielu",
}


def _hf_act(act: str) -> str:
    if act not in _HF_ACTS:
        raise ValueError(
            f"Unsupported hidden_act={act!r} (the port's MLP runs "
            f"{sorted(set(_HF_ACTS.values()))}; ROADMAP.md lists the rest)"
        )
    return _HF_ACTS[act]


def _hf_gpt2(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """GPT-2: learned ``wpe`` positions and no rotary, pre-LayerNorm blocks,
    a non-gated biased ``gelu_new`` MLP, biases on every projection,
    always tied (its Conv1D checkpoint is split and transposed on load,
    ``hf_loader.translate_gpt2_state_dict``).  ``scale_attn_weights=False``
    leaves the logits unscaled."""
    if hf.get("scale_attn_by_inverse_layer_idx") or hf.get("reorder_and_upcast_attn"):
        raise ValueError(
            "gpt2 scale_attn_by_inverse_layer_idx / reorder_and_upcast_attn are not "
            "implemented, as in the JAX package"
        )
    dim, n_heads, inner = int(hf["n_embd"]), int(hf["n_head"]), hf.get("n_inner")
    return TransformerConfig(
        vocab_size=int(hf["vocab_size"]), dim=dim, n_layers=int(hf["n_layer"]),
        n_heads=n_heads, n_kv_heads=n_heads, hidden_dim=int(inner) if inner else 4 * dim,
        norm_eps=float(hf.get("layer_norm_epsilon", 1e-5)), norm_type="layernorm",
        mlp_gated=False, mlp_bias=True,
        mlp_act=_hf_act(hf.get("activation_function", "gelu_new")),
        qkv_bias=True, o_proj_bias=True, use_rope=False, learned_pos=int(hf["n_positions"]),
        tie_embeddings=True,
        query_scale_override=None if hf.get("scale_attn_weights", True) else 1.0,
        remat=remat, dtype=dtype,
    )


def _hf_gpt_neox(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """GPT-NeoX (Pythia): rotate-half rotary over ``rotary_pct`` of each
    head, LayerNorm, a non-gated exact-GELU MLP, biases, the per-head fused
    ``query_key_value`` split on load, and ``use_parallel_residual``'s
    two-norm wiring."""
    pct = float(hf.get("rotary_pct", 0.25))
    n_heads = int(hf["num_attention_heads"])
    bias = bool(hf.get("attention_bias", True))
    return TransformerConfig(
        vocab_size=int(hf["vocab_size"]), dim=int(hf["hidden_size"]),
        n_layers=int(hf["num_hidden_layers"]), n_heads=n_heads, n_kv_heads=n_heads,
        hidden_dim=int(hf["intermediate_size"]), norm_eps=float(hf.get("layer_norm_eps", 1e-5)),
        norm_type="layernorm", mlp_gated=False, mlp_bias=True,
        mlp_act=_hf_act(hf.get("hidden_act", "gelu")), qkv_bias=bias, o_proj_bias=bias,
        rope_theta=float(hf.get("rotary_emb_base", hf.get("rope_theta", 10000.0))),
        rope_partial_factor=pct if pct < 1.0 else None,
        parallel_residual="two_norm" if hf.get("use_parallel_residual", True) else "none",
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)), remat=remat, dtype=dtype,
    )


def _hf_falcon(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """Falcon's three block wirings: ``new_decoder_architecture`` (ln_attn /
    ln_mlp, two-norm parallel, grouped kv heads), the classic
    ``parallel_attn`` block (one norm shared by both branches, one kv head
    with ``multi_query``) and the sequential falcon-rw block; the fused
    ``query_key_value`` is split per layout on load.  ALiBi is refused, as
    in the JAX package."""
    if hf.get("alibi"):
        raise ValueError("falcon alibi positions are not implemented, as in the JAX package")
    dim, n_heads = int(hf["hidden_size"]), int(hf["num_attention_heads"])
    if hf.get("new_decoder_architecture", False):
        n_kv, parallel = int(hf.get("num_kv_heads") or n_heads), "two_norm"
    else:
        n_kv = 1 if hf.get("multi_query", True) else n_heads
        parallel = "one_norm" if hf.get("parallel_attn", True) else "none"
    bias, ffn = bool(hf.get("bias", False)), hf.get("ffn_hidden_size")
    return TransformerConfig(
        vocab_size=int(hf["vocab_size"]), dim=dim, n_layers=int(hf["num_hidden_layers"]),
        n_heads=n_heads, n_kv_heads=n_kv, hidden_dim=int(ffn) if ffn else 4 * dim,
        norm_eps=float(hf.get("layer_norm_epsilon", 1e-5)), norm_type="layernorm",
        mlp_gated=False, mlp_bias=bias,
        mlp_act=_hf_act(hf.get("activation", hf.get("hidden_act", "gelu"))),
        qkv_bias=bias, o_proj_bias=bias, rope_theta=float(hf.get("rope_theta", 10000.0)),
        parallel_residual=parallel, tie_embeddings=bool(hf.get("tie_word_embeddings", True)),
        remat=remat, dtype=dtype,
    )


def _hf_starcoder2(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """StarCoder2: the llama graph with LayerNorm, a non-gated tanh-GELU MLP
    (``c_fc`` / ``c_proj`` renamed to up / down on load) and ``use_bias`` on
    every projection; full rotary, grouped kv heads.  Its window is logged
    and not applied, as in the JAX package."""
    bias = bool(hf.get("use_bias", True))
    if hf.get("sliding_window"):
        logger.info(
            "starcoder2 sliding_window=%s: full causal attention is used; keep sequences "
            "within the window for exactness", hf["sliding_window"],
        )
    n_heads = int(hf["num_attention_heads"])
    return TransformerConfig(
        vocab_size=int(hf["vocab_size"]), dim=int(hf["hidden_size"]),
        n_layers=int(hf["num_hidden_layers"]), n_heads=n_heads,
        n_kv_heads=int(hf.get("num_key_value_heads", n_heads)),
        hidden_dim=int(hf["intermediate_size"]), norm_eps=float(hf.get("norm_epsilon", 1e-5)),
        norm_type="layernorm", mlp_gated=False, mlp_bias=bias,
        mlp_act=_hf_act(hf.get("hidden_act", "gelu_pytorch_tanh")), qkv_bias=bias,
        o_proj_bias=bias, rope_theta=float(hf.get("rope_theta", 10000.0)),
        tie_embeddings=bool(hf.get("tie_word_embeddings", True)), remat=remat, dtype=dtype,
    )


def _hf_stablelm(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """StableLM: the llama graph with LayerNorm blocks and rotate-half
    rotary over ``partial_rotary_factor`` of each head; a gated silu MLP;
    q/k/v biases with ``use_qkv_bias``.  ``qk_layernorm`` and
    ``use_parallel_residual`` are refused, as in the JAX package."""
    if hf.get("qk_layernorm"):
        raise ValueError("stablelm qk_layernorm is not implemented, as in the JAX package")
    if hf.get("use_parallel_residual"):
        raise ValueError("stablelm use_parallel_residual is not implemented, as in the JAX package")
    pct = float(hf.get("partial_rotary_factor", 0.25))
    n_heads = int(hf["num_attention_heads"])
    return TransformerConfig(
        vocab_size=int(hf["vocab_size"]), dim=int(hf["hidden_size"]),
        n_layers=int(hf["num_hidden_layers"]), n_heads=n_heads,
        n_kv_heads=int(hf.get("num_key_value_heads", n_heads)),
        hidden_dim=int(hf["intermediate_size"]), norm_eps=float(hf.get("layer_norm_eps", 1e-5)),
        norm_type="layernorm", mlp_act=_hf_act(hf.get("hidden_act", "silu")),
        qkv_bias=bool(hf.get("use_qkv_bias", False)),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rope_partial_factor=pct if pct < 1.0 else None,
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)), remat=remat, dtype=dtype,
    )


def _hf_granite(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """Granite: the llama graph with four multipliers: ``embedding_multiplier``
    on the embeddings, ``residual_multiplier`` on both residual branches,
    ``attention_multiplier`` as the softmax scale (kept as
    ``query_scale_override = multiplier ** -2``, whose ``** -0.5`` gives it
    back) and the logits divided by ``logits_scaling``."""
    attn_mult = float(hf.get("attention_multiplier", 1.0))
    logits_scaling = float(hf.get("logits_scaling", 1.0))

    def opt_float(key: str) -> Optional[float]:
        return float(hf[key]) if hf.get(key) is not None else None

    n_heads = int(hf["num_attention_heads"])
    return TransformerConfig(
        vocab_size=int(hf["vocab_size"]), dim=int(hf["hidden_size"]),
        n_layers=int(hf["num_hidden_layers"]), n_heads=n_heads,
        n_kv_heads=int(hf.get("num_key_value_heads", n_heads)),
        hidden_dim=int(hf["intermediate_size"]), norm_eps=float(hf.get("rms_norm_eps", 1e-6)),
        mlp_act=_hf_act(hf.get("hidden_act", "silu")),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        embedding_multiplier=opt_float("embedding_multiplier"),
        residual_multiplier=opt_float("residual_multiplier"),
        query_scale_override=attn_mult ** -2 if attn_mult != 1.0 else None,
        logit_scale=1.0 / logits_scaling if logits_scaling != 1.0 else None,
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)), remat=remat, dtype=dtype,
    )


def _hf_cohere(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """Cohere (Command-R): LayerNorm without an offset, one input norm
    shared by the parallel attention and MLP branches, a gated silu MLP,
    pair-interleaved rotary over the whole head and ``logit_scale`` on the
    tied logits.  ``use_qk_norm`` is refused, as in the JAX package."""
    if hf.get("use_qk_norm"):
        raise ValueError("cohere use_qk_norm is not implemented, as in the JAX package")
    n_heads = int(hf["num_attention_heads"])
    return TransformerConfig(
        vocab_size=int(hf["vocab_size"]), dim=int(hf["hidden_size"]),
        n_layers=int(hf["num_hidden_layers"]), n_heads=n_heads,
        n_kv_heads=int(hf.get("num_key_value_heads", n_heads)),
        hidden_dim=int(hf["intermediate_size"]), norm_eps=float(hf.get("layer_norm_eps", 1e-5)),
        norm_type="layernorm", norm_bias=False, mlp_act=_hf_act(hf.get("hidden_act", "silu")),
        qkv_bias=bool(hf.get("attention_bias", False)),
        rope_theta=float(hf.get("rope_theta", 10000.0)), rope_interleaved=True,
        parallel_residual="one_norm", logit_scale=float(hf.get("logit_scale", 0.0625)),
        tie_embeddings=bool(hf.get("tie_word_embeddings", True)), remat=remat, dtype=dtype,
    )


def _gptj_graph(hf: dict, dtype: torch.dtype, remat: bool, rotary_dim: Any) -> TransformerConfig:
    """GPT-J's graph, which CodeGen shares: pair-interleaved rotary over the
    first ``rotary_dim`` dims of each head, one LayerNorm feeding the
    parallel attention and MLP, bias-free q/k/v/o, a biased non-gated
    ``gelu_new`` MLP and an untied head with a bias."""
    dim, n_heads, inner = int(hf["n_embd"]), int(hf["n_head"]), hf.get("n_inner")
    hd = dim // n_heads
    return TransformerConfig(
        vocab_size=int(hf["vocab_size"]), dim=dim, n_layers=int(hf["n_layer"]),
        n_heads=n_heads, n_kv_heads=n_heads, hidden_dim=int(inner) if inner else 4 * dim,
        norm_eps=float(hf.get("layer_norm_epsilon", 1e-5)), norm_type="layernorm",
        mlp_gated=False, mlp_bias=True,
        mlp_act=_hf_act(hf.get("activation_function", "gelu_new")),
        rope_theta=10000.0, rope_interleaved=True,
        rope_partial_factor=int(rotary_dim) / hd if rotary_dim and int(rotary_dim) < hd else None,
        parallel_residual="one_norm", tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
        lm_head_bias=True, remat=remat, dtype=dtype,
    )


def _hf_gptj(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """GPT-J: ``_gptj_graph`` at its ``rotary_dim`` (all of each head when
    absent); the checkpoint's names are renamed on load
    (``hf_loader.translate_gptj_state_dict``)."""
    return _gptj_graph(hf, dtype, remat, hf.get("rotary_dim"))


def _hf_codegen(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """CodeGen: GPT-J's graph, its bias-free q/k/v fused in the ``mp_num``
    = 4 sharded (q, v, k) layout and split on load
    (``hf_loader.make_codegen_translator``).  A config without
    ``rotary_dim`` is refused, as in the JAX package (HF then rotates the
    whole embedding, not each head)."""
    if not hf.get("rotary_dim"):
        raise ValueError(
            "codegen without rotary_dim is not implemented, as in the JAX package (the fallback "
            "rotates the whole embed dim, not per-head dims)"
        )
    return _gptj_graph(hf, dtype, remat, hf["rotary_dim"])


def _hf_gpt_neo(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """GPT-Neo: learned positions, unscaled attention logits
    (``query_scale_override`` 1.0), its "local" layers windowed to the last
    ``window_size`` keys (``sliding_attention``), bias-free q/k/v with a
    biased out_proj and a non-gated ``gelu_new`` MLP."""
    layers = [str(t) for t in hf.get("attention_layers") or []] or (
        ["global"] * int(hf["num_layers"]))
    has_local = "local" in layers
    dim, n_heads = int(hf["hidden_size"]), int(hf["num_heads"])
    return TransformerConfig(
        vocab_size=int(hf["vocab_size"]), dim=dim, n_layers=int(hf["num_layers"]),
        n_heads=n_heads, n_kv_heads=n_heads, hidden_dim=int(hf.get("intermediate_size") or 4 * dim),
        norm_eps=float(hf.get("layer_norm_epsilon", 1e-5)), norm_type="layernorm",
        mlp_gated=False, mlp_bias=True,
        mlp_act=_hf_act(hf.get("activation_function", "gelu_new")), o_proj_bias=True,
        learned_pos=int(hf["max_position_embeddings"]), use_rope=False, query_scale_override=1.0,
        sliding_window=int(hf.get("window_size", 256)) if has_local else None,
        layer_types=tuple(
            "sliding_attention" if t == "local" else "full_attention" for t in layers
        ) if has_local else (),
        tie_embeddings=bool(hf.get("tie_word_embeddings", True)), remat=remat, dtype=dtype,
    )


def _hf_gpt_bigcode(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """GPTBigCode (StarCoder, SantaCoder): GPT-2's blocks and learned
    positions with multi-query attention (one kv head; the fused ``c_attn``
    is split on load, ``hf_loader.make_gpt_bigcode_translator``), tied.
    ``multi_query=False`` is refused, as in the JAX package."""
    if not hf.get("multi_query", True):
        raise ValueError("gpt_bigcode multi_query=False is not implemented, as in the JAX package")
    dim, n_heads, inner = int(hf["n_embd"]), int(hf["n_head"]), hf.get("n_inner")
    return TransformerConfig(
        vocab_size=int(hf["vocab_size"]), dim=dim, n_layers=int(hf["n_layer"]),
        n_heads=n_heads, n_kv_heads=1, hidden_dim=int(inner) if inner else 4 * dim,
        norm_eps=float(hf.get("layer_norm_epsilon", 1e-5)), norm_type="layernorm",
        mlp_gated=False, mlp_bias=True,
        mlp_act=_hf_act(hf.get("activation_function", "gelu_pytorch_tanh")),
        qkv_bias=True, o_proj_bias=True, use_rope=False, learned_pos=int(hf["n_positions"]),
        query_scale_override=None if hf.get("scale_attn_weights", True) else 1.0,
        tie_embeddings=True, remat=remat, dtype=dtype,
    )


def _hf_opt(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """OPT: learned positions (the checkpoint's two legacy offset rows are
    dropped on load, ``hf_loader.translate_opt_state_dict``), pre-LN
    blocks, a non-gated relu MLP and ``enable_bias`` on every projection.
    The 350m layout (``word_embed_proj_dim != hidden_size``,
    ``do_layer_norm_before=False``) and LayerNorms without an affine are
    refused, as in the JAX package."""
    dim = int(hf["hidden_size"])
    if int(hf.get("word_embed_proj_dim", dim)) != dim:
        raise ValueError(
            "opt word_embed_proj_dim != hidden_size (project_in / project_out, the 350m layout) "
            "is not implemented, as in the JAX package"
        )
    if not hf.get("do_layer_norm_before", True):
        raise ValueError(
            "opt do_layer_norm_before=False (the 350m post-norm layout) is not implemented, as "
            "in the JAX package"
        )
    if not hf.get("layer_norm_elementwise_affine", True):
        raise ValueError(
            "opt layer_norm_elementwise_affine=False is not implemented, as in the JAX package"
        )
    bias, n_heads = bool(hf.get("enable_bias", True)), int(hf["num_attention_heads"])
    return TransformerConfig(
        vocab_size=int(hf["vocab_size"]), dim=dim, n_layers=int(hf["num_hidden_layers"]),
        n_heads=n_heads, n_kv_heads=n_heads, hidden_dim=int(hf["ffn_dim"]), norm_eps=1e-5,
        norm_type="layernorm", mlp_gated=False, mlp_bias=bias,
        mlp_act=_hf_act(hf.get("activation_function", "relu")), qkv_bias=bias, o_proj_bias=bias,
        use_rope=False, learned_pos=int(hf["max_position_embeddings"]),
        tie_embeddings=bool(hf.get("tie_word_embeddings", True)), remat=remat, dtype=dtype,
    )


def _hf_openai_gpt(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """GPT-1: GPT-2's Conv1D layout with post-LN blocks (ln_1 / ln_2 after
    each residual add), no final norm, learned positions and a tied head;
    its ``afn`` "gelu" is the tanh form (HF's ``ACT_FNS``)."""
    afn = hf.get("afn", "gelu")
    act = {"gelu": "gelu_tanh", "relu": "relu", "silu": "silu", "swish": "silu"}.get(afn)
    if act is None:
        raise ValueError(f"openai-gpt afn {afn!r} is not implemented, as in the JAX package")
    dim, n_heads = int(hf["n_embd"]), int(hf["n_head"])
    return TransformerConfig(
        vocab_size=int(hf["vocab_size"]), dim=dim, n_layers=int(hf["n_layer"]),
        n_heads=n_heads, n_kv_heads=n_heads, hidden_dim=4 * dim,
        norm_eps=float(hf.get("layer_norm_epsilon", 1e-5)), norm_type="layernorm",
        post_ln=True, final_norm=False, mlp_gated=False, mlp_bias=True, mlp_act=act,
        qkv_bias=True, o_proj_bias=True, use_rope=False, learned_pos=int(hf["n_positions"]),
        tie_embeddings=True, remat=remat, dtype=dtype,
    )


def _hf_imagegpt(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """ImageGPT: GPT-2's graph over colour-cluster tokens, with RMSNorm
    blocks (its LayerNorm neither centres nor offsets), a ``quick_gelu``
    MLP and an untied head of ``vocab_size - 1`` outputs over an embedding
    of ``vocab_size`` rows (the start token is never predicted)."""
    dim, n_heads, inner = int(hf["n_embd"]), int(hf["n_head"]), hf.get("n_inner")
    vocab = int(hf["vocab_size"])
    return TransformerConfig(
        vocab_size=vocab - 1, embed_vocab_size=vocab, dim=dim, n_layers=int(hf["n_layer"]),
        n_heads=n_heads, n_kv_heads=n_heads, hidden_dim=int(inner) if inner else 4 * dim,
        norm_eps=float(hf.get("layer_norm_epsilon", 1e-5)), mlp_gated=False, mlp_bias=True,
        mlp_act=_hf_act(hf.get("activation_function", "quick_gelu")), qkv_bias=True,
        o_proj_bias=True, use_rope=False, learned_pos=int(hf["n_positions"]),
        tie_embeddings=False, remat=remat, dtype=dtype,
    )


def _llama3_scaling(rs: dict) -> tuple:
    """A llama3 ``rope_scaling`` as ``rope_llama3_scaling``: (factor,
    low_freq_factor, high_freq_factor, original_max_position_embeddings)."""
    return (float(rs["factor"]), float(rs.get("low_freq_factor", 1.0)),
            float(rs.get("high_freq_factor", 4.0)),
            int(rs.get("original_max_position_embeddings", 8192)))


def _explicit_head_dim(hf: dict) -> Optional[int]:
    """``head_dim`` where it is not hidden_size / heads, else None (the JAX
    constructors' ``head_dim_override``)."""
    hd = hf.get("head_dim")
    if hd is None or int(hd) * int(hf["num_attention_heads"]) == int(hf["hidden_size"]):
        return None
    return int(hd)


def _deepseek_moe(hf: dict, mt: str) -> dict[str, Any]:
    """DeepSeek-V2 / V3's MoE and routing fields, as the JAX package's
    branch reads them (HF DeepseekV2MoEGate / DeepseekV3TopkRouter): the
    first ``first_k_dense_replace`` layers dense (``mlp_only_layers``), an
    ungated shared expert of ``moe_intermediate_size * n_shared_experts``;
    v3 scores by sigmoid with the correction bias and top-2-sum groups, v2's
    ``group_limited_greedy`` by softmax with max groups, and any other v2
    ``topk_method`` than ``greedy`` is refused."""
    moe_hidden = int(hf["moe_intermediate_size"])
    moe: dict[str, Any] = dict(
        n_experts=int(hf["n_routed_experts"]),
        # HF's default DeepseekV2Config holds num_experts_per_tok None
        n_experts_per_tok=int(hf.get("num_experts_per_tok") or 8),
        norm_topk_prob=bool(hf.get("norm_topk_prob", False)),
        moe_hidden_dim=moe_hidden,
        mlp_only_layers=tuple(range(int(hf.get("first_k_dense_replace", 0)))),
        shared_expert_hidden_dim=moe_hidden * int(hf.get("n_shared_experts") or 1),
        shared_expert_gated=False,
        routed_scaling_factor=float(hf.get("routed_scaling_factor", 1.0)),
    )
    if mt == "deepseek_v3":
        moe.update(router_score_func="sigmoid", router_group_top2_sum=True,
                   router_correction_bias=True, router_n_group=int(hf.get("n_group", 1)),
                   router_topk_group=int(hf.get("topk_group", 1)))
    elif hf.get("topk_method") == "group_limited_greedy":
        moe.update(router_n_group=int(hf.get("n_group", 1)),
                   router_topk_group=int(hf.get("topk_group", 1)))
    elif hf.get("topk_method", "greedy") != "greedy":
        raise ValueError(
            f"deepseek topk_method={hf.get('topk_method')!r} is not implemented, as in the JAX "
            "package"
        )
    return moe


def _deepseek_mla(hf: dict, rs: Optional[dict]) -> dict[str, Any]:
    """The latent-attention fields; with yarn past factor 1 the softmax
    scale gains mscale^2, mscale = 0.1 * mscale_all_dim * ln(factor) + 1
    (HF DeepseekV2/V3Attention)."""
    scale = None
    if rs is not None and rs.get("mscale_all_dim"):
        factor = float(rs["factor"])
        if factor > 1:
            scale = (0.1 * float(rs["mscale_all_dim"]) * math.log(factor) + 1.0) ** 2
    return dict(
        q_lora_rank=int(hf["q_lora_rank"]) if hf.get("q_lora_rank") is not None else None,
        kv_lora_rank=int(hf["kv_lora_rank"]),
        qk_rope_head_dim=int(hf.get("qk_rope_head_dim", 64)),
        qk_nope_head_dim=int(hf.get("qk_nope_head_dim", 128)),
        v_head_dim=int(hf.get("v_head_dim", 128)),
        mla_softmax_scale=scale,
    )


def _llama_lineage(hf: dict, dtype: torch.dtype, remat: bool, **knobs: Any) -> TransformerConfig:
    """The llama graph's widths as the lineage's JAX constructors read them
    (``num_key_value_heads`` absent or null: one kv head a query head;
    rope_theta 10000 and an untied head unless given), with the family's
    ``knobs`` over them."""
    n_heads = int(hf["num_attention_heads"])
    widths = dict(
        vocab_size=int(hf["vocab_size"]), dim=int(hf["hidden_size"]),
        n_layers=int(hf["num_hidden_layers"]), n_heads=n_heads,
        n_kv_heads=int(hf.get("num_key_value_heads") or n_heads),
        hidden_dim=int(hf["intermediate_size"]), rope_theta=float(hf.get("rope_theta", 10000.0)),
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)), remat=remat, dtype=dtype,
    )
    return TransformerConfig(**{**widths, **knobs})


def _hf_olmo(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """OLMo (v1): the llama graph with LayerNorms that have no weight and no
    bias (OlmoLayerNorm, its eps fixed at 1e-5) and the optional
    ``clip_qkv`` clamp; a gated MLP, full rotary, no biases.
    ``attention_bias`` is refused, as in the JAX package."""
    if hf.get("attention_bias", False):
        raise ValueError("olmo attention_bias=True is not expressed, as in the JAX package")
    clip = hf.get("clip_qkv")
    return _llama_lineage(
        hf, dtype, remat, norm_eps=1e-5, norm_type="layernorm", norm_no_affine=True,
        clip_qkv=float(clip) if clip is not None else None,
        mlp_act=_hf_act(hf.get("hidden_act", "silu")),
    )


def _hf_nemotron(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """Nemotron: LayerNorm1P blocks (y * (w + 1) + b, w zero-initialized), a
    non-gated squared-relu MLP and rotate-half rotary over
    ``partial_rotary_factor`` of each head."""
    pct = float(hf.get("partial_rotary_factor", 0.5))
    bias = bool(hf.get("attention_bias", False))
    return _llama_lineage(
        hf, dtype, remat, norm_eps=float(hf.get("norm_eps", 1e-5)), norm_type="layernorm",
        norm_plus_one=True, mlp_gated=False, mlp_bias=bool(hf.get("mlp_bias", False)),
        mlp_act=_hf_act(hf.get("hidden_act", "relu2")), qkv_bias=bias, o_proj_bias=bias,
        rope_partial_factor=pct if pct < 1.0 else None,
    )


def _hf_persimmon(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """Persimmon (and Fuyu's text path): LayerNorm blocks, biases on every
    projection, a per-head q/k LayerNorm with a bias (``qk_layernorm``),
    rotate-half rotary over ``partial_rotary_factor`` of each head and a
    non-gated squared-relu MLP; multi-head attention only.  Its per-head
    fused ``query_key_value`` is split on load
    (``hf_loader.make_persimmon_translator``)."""
    pct = float(hf.get("partial_rotary_factor", 0.5))
    return _llama_lineage(
        hf, dtype, remat, n_kv_heads=int(hf["num_attention_heads"]),
        norm_eps=float(hf.get("layer_norm_eps", 1e-5)), norm_type="layernorm",
        qk_norm=bool(hf.get("qk_layernorm", True)), qk_norm_type="layernorm", mlp_gated=False,
        mlp_bias=True, mlp_act=_hf_act(hf.get("hidden_act", "relu2")), qkv_bias=True,
        o_proj_bias=True, rope_theta=float(hf.get("rope_theta", 25000.0)),
        rope_partial_factor=pct if pct < 1.0 else None,
    )


def _hf_ernie4_5(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """ERNIE-4.5 (dense): one ``use_bias`` over q/k/v, o_proj and the gated
    MLP, pair-interleaved rotary over the whole head, an explicit
    ``head_dim``, tied unless told otherwise."""
    bias = bool(hf.get("use_bias", False))
    return _llama_lineage(
        hf, dtype, remat, norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        head_dim_override=_explicit_head_dim(hf), mlp_act=_hf_act(hf.get("hidden_act", "silu")),
        mlp_bias=bias, qkv_bias=bias, o_proj_bias=bias, rope_interleaved=True,
        tie_embeddings=bool(hf.get("tie_word_embeddings", True)),
    )


def _hf_arcee(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """Arcee (AFM): the llama graph with a non-gated squared-relu MLP and
    an explicit ``head_dim``."""
    bias = bool(hf.get("attention_bias", False))
    return _llama_lineage(
        hf, dtype, remat, norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        head_dim_override=_explicit_head_dim(hf), mlp_gated=False,
        mlp_bias=bool(hf.get("mlp_bias", False)), mlp_act=_hf_act(hf.get("hidden_act", "relu2")),
        qkv_bias=bias, o_proj_bias=bias,
    )


def _hf_seed_oss(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """Seed-OSS: the llama graph with split bias knobs, ``attention_bias``
    (on by default) on q/k/v and ``attention_out_bias`` on o_proj, and an
    explicit ``head_dim``."""
    return _llama_lineage(
        hf, dtype, remat, norm_eps=float(hf.get("rms_norm_eps", 1e-6)),
        head_dim_override=_explicit_head_dim(hf), mlp_act=_hf_act(hf.get("hidden_act", "silu")),
        mlp_bias=bool(hf.get("mlp_bias", False)), qkv_bias=bool(hf.get("attention_bias", True)),
        o_proj_bias=bool(hf.get("attention_out_bias", False)),
    )


def _hf_exaone4(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """EXAONE-4: OLMo-2's post-norm-only blocks with per-head q/k RMSNorms
    and hybrid sliding layers (``layer_types``, or every
    ``sliding_window_pattern``-th layer full); with a window, only the
    sliding layers rotate (``rope_layers``)."""
    sliding = hf.get("sliding_window")
    layer_types = tuple(hf.get("layer_types") or ())
    if not layer_types and sliding:
        pat = int(hf.get("sliding_window_pattern") or 4)
        layer_types = tuple("full_attention" if (i + 1) % pat == 0 else "sliding_attention"
                            for i in range(int(hf["num_hidden_layers"])))
    return _llama_lineage(
        hf, dtype, remat, norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        head_dim_override=_explicit_head_dim(hf), qk_norm=True, post_norm_only=True,
        mlp_act=_hf_act(hf.get("hidden_act", "silu")),
        qkv_bias=bool(hf.get("attention_bias") or False),
        sliding_window=int(sliding) if sliding else None, layer_types=layer_types,
        rope_layers=tuple(int(t == "sliding_attention") for t in layer_types) if sliding else (),
    )


def _hf_vaultgemma(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """VaultGemma: Gemma-2's knobs ((1 + w) RMSNorms, the sqrt(dim)
    embedding scale, soft-caps, ``query_pre_attn_scalar``, hybrid sliding
    layers, even layers sliding by default) in plain pre-norm blocks, whose
    pre-MLP norm the checkpoint names ``pre_feedforward_layernorm``
    (renamed on load); tied."""
    sliding = hf.get("sliding_window")
    layer_types = tuple(hf.get("layer_types") or ())
    if not layer_types and sliding:
        layer_types = tuple("sliding_attention" if i % 2 == 0 else "full_attention"
                            for i in range(int(hf["num_hidden_layers"])))

    def opt_float(key: str) -> Optional[float]:
        return float(hf[key]) if hf.get(key) is not None else None

    return _llama_lineage(
        hf, dtype, remat, norm_eps=float(hf.get("rms_norm_eps", 1e-6)),
        head_dim_override=_explicit_head_dim(hf),
        mlp_act=_hf_act(hf.get("hidden_activation") or hf.get("hidden_act", "gelu_pytorch_tanh")),
        scale_embeddings=True, norm_plus_one=True,
        attn_logit_softcap=opt_float("attn_logit_softcapping"),
        final_logit_softcap=opt_float("final_logit_softcapping"),
        query_scale_override=opt_float("query_pre_attn_scalar"),
        sliding_window=int(sliding) if sliding else None, layer_types=layer_types,
        tie_embeddings=bool(hf.get("tie_word_embeddings", True)),
    )


def _hf_apertus(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """Apertus: llama attention with per-head q/k RMSNorms, a non-gated
    xIELU MLP whose two scalars are learned (``MLP.act_alpha_p`` /
    ``act_alpha_n``) and llama3 rope scaling; its checkpoint's norm and
    alpha names are renamed on load.  Other rope scalings are refused, as
    in the JAX package."""
    rs = hf.get("rope_scaling")
    rtype = None if rs is None else rs.get("rope_type", rs.get("type"))
    if rtype not in (None, "default", "llama3"):
        raise ValueError(f"apertus rope_scaling type {rtype!r} is not implemented, as in the JAX "
                         "package")
    bias = bool(hf.get("attention_bias", False))
    return _llama_lineage(
        hf, dtype, remat, norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        head_dim_override=_explicit_head_dim(hf), qk_norm=True, mlp_gated=False,
        mlp_act=_hf_act(hf.get("hidden_act", "xielu")), mlp_bias=bool(hf.get("mlp_bias", False)),
        qkv_bias=bias, o_proj_bias=bias,
        rope_llama3_scaling=_llama3_scaling(rs) if rtype == "llama3" else None,
    )


def _hf_hunyuan_dense(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """HunYuan (dense): the llama graph with per-head q/k RMSNorms, named
    ``query_layernorm`` / ``key_layernorm`` in the checkpoint (renamed on
    load).  ``rope_scaling`` is refused, as in the JAX package."""
    if hf.get("rope_scaling") is not None:
        raise ValueError("hunyuan rope_scaling is not implemented, as in the JAX package")
    bias = bool(hf.get("attention_bias", False))
    return _llama_lineage(
        hf, dtype, remat, norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        head_dim_override=_explicit_head_dim(hf), qk_norm=True,
        mlp_act=_hf_act(hf.get("hidden_act", "silu")), qkv_bias=bias, o_proj_bias=bias,
    )


def _silu_only(hf: dict, family: str) -> str:
    act = _hf_act(hf.get("hidden_act", "silu"))
    if act != "silu":
        raise ValueError(f"{family} hidden_act {hf.get('hidden_act')!r} is not implemented, as "
                         "in the JAX package")
    return act


def _hf_helium(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """Helium: the llama graph with pair-interleaved rotary over the whole
    head, an explicit ``head_dim`` (kept even where it is hidden_size /
    heads, as JAX keeps it), q/k/v and MLP biases by config (o_proj never
    biased) and rms eps 1e-8.  Only silu is built, as in the JAX package."""
    return _llama_lineage(
        hf, dtype, remat, head_dim_override=int(hf["head_dim"]) if hf.get("head_dim") else None,
        norm_eps=float(hf.get("rms_norm_eps", 1e-8)), mlp_act=_silu_only(hf, "helium"),
        rope_theta=float(hf.get("rope_theta", 100000.0)), rope_interleaved=True,
        qkv_bias=bool(hf.get("attention_bias", False)), mlp_bias=bool(hf.get("mlp_bias", False)),
    )


def _hf_open_llama(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """OpenLLaMA (HF's deprecated ``open-llama``): the llama graph with
    ``use_stable_embedding``'s LayerNorm over the token embedding (at
    rms_norm_eps, as JAX builds it) and ``shared_input_output_embedding``
    tying; multi-head attention.  Only silu is built, as in the JAX
    package."""
    return _llama_lineage(
        hf, dtype, remat, n_kv_heads=int(hf["num_attention_heads"]),
        norm_eps=float(hf.get("rms_norm_eps", 1e-6)), mlp_act=_silu_only(hf, "open-llama"),
        embed_norm=bool(hf.get("use_stable_embedding", True)),
        tie_embeddings=bool(hf.get("shared_input_output_embedding", True)),
    )


def _hf_cohere2(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """Cohere2 (Command-R7B): Cohere's one-norm parallel block with hybrid
    sliding layers (``layer_types``, or every ``sliding_window_pattern``-th
    layer full), where only the sliding layers rotate (``rope_layers``).
    ``use_qk_norm`` is refused, as in the JAX package."""
    if hf.get("use_qk_norm"):
        raise ValueError("cohere2 use_qk_norm is not implemented, as in the JAX package")
    sliding = hf.get("sliding_window")
    layer_types = tuple(hf.get("layer_types") or ())
    if not layer_types and sliding:
        pat = int(hf.get("sliding_window_pattern") or 4)
        layer_types = tuple("full_attention" if (i + 1) % pat == 0 else "sliding_attention"
                            for i in range(int(hf["num_hidden_layers"])))
    return _llama_lineage(
        hf, dtype, remat, norm_eps=float(hf.get("layer_norm_eps", 1e-5)), norm_type="layernorm",
        norm_bias=False, head_dim_override=_explicit_head_dim(hf),
        mlp_act=_hf_act(hf.get("hidden_act", "silu")),
        qkv_bias=bool(hf.get("attention_bias", False)), rope_interleaved=True,
        parallel_residual="one_norm", logit_scale=float(hf.get("logit_scale", 0.0625)),
        sliding_window=int(sliding) if sliding else None, layer_types=layer_types,
        rope_layers=tuple(int(t == "sliding_attention") for t in layer_types) if sliding else (),
        tie_embeddings=bool(hf.get("tie_word_embeddings", True)),
    )


def _hf_gpt_neox_japanese(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """GPT-NeoX-Japanese: sequential NeoX blocks (LayerNorm, a bias-free
    non-gated MLP of ``intermediate_multiple_size`` times the width),
    split-half rotary over ``rotary_pct`` of each head, bias-free q/k/v from
    the per-head fused ``query_key_value``, and an o_proj bias that the
    checkpoint holds on the last layer only (the others zero-filled on
    load, ``hf_loader.make_gpt_neox_japanese_translator``)."""
    dim, n_heads = int(hf["hidden_size"]), int(hf["num_attention_heads"])
    pct = float(hf.get("rotary_pct", 1.0))
    return TransformerConfig(
        vocab_size=int(hf["vocab_size"]), dim=dim, n_layers=int(hf["num_hidden_layers"]),
        n_heads=n_heads, n_kv_heads=n_heads,
        hidden_dim=int(dim * float(hf.get("intermediate_multiple_size", 4))),
        norm_eps=float(hf.get("layer_norm_eps", 1e-5)), norm_type="layernorm", mlp_gated=False,
        mlp_act=_hf_act(hf.get("hidden_act", "gelu")), o_proj_bias=True,
        rope_theta=float(hf.get("rotary_emb_base", 10000.0)),
        rope_partial_factor=pct if pct < 1.0 else None,
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)), remat=remat, dtype=dtype,
    )


def _hf_biogpt(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """BioGPT: OPT's pre-LN blocks (biases everywhere, a non-gated exact-GELU
    MLP) with the sqrt(dim) embedding scale and learned positions (the
    checkpoint's two offset rows dropped on load); tied."""
    n_heads = int(hf["num_attention_heads"])
    return TransformerConfig(
        vocab_size=int(hf["vocab_size"]), dim=int(hf["hidden_size"]),
        n_layers=int(hf["num_hidden_layers"]), n_heads=n_heads, n_kv_heads=n_heads,
        hidden_dim=int(hf["intermediate_size"]), norm_eps=float(hf.get("layer_norm_eps", 1e-12)),
        norm_type="layernorm", mlp_gated=False, mlp_bias=True,
        mlp_act=_hf_act(hf.get("hidden_act", "gelu")), qkv_bias=True, o_proj_bias=True,
        learned_pos=int(hf["max_position_embeddings"]), use_rope=False,
        scale_embeddings=bool(hf.get("scale_embedding", True)), tie_embeddings=True,
        remat=remat, dtype=dtype,
    )


def _hf_xlm(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """XLM as a causal LM: post-LN blocks and no final norm, learned
    positions, a LayerNorm over the embedding, an exact-GELU (or relu) MLP
    and a tied head with a bias of its own (``tied_head_bias``); its
    language table is dropped on load.  ``causal=False`` (a bidirectional
    encoder) and ``asm`` (an adaptive softmax head) are refused, as in the
    JAX package."""
    if not hf.get("causal"):
        raise ValueError("xlm with causal=False is a bidirectional encoder, not a causal "
                         "decoder, as the JAX package says")
    if hf.get("asm"):
        raise ValueError("xlm asm=True (adaptive softmax head) is not implemented, as in the JAX "
                         "package")
    dim, n_heads = int(hf["emb_dim"]), int(hf["n_heads"])
    return TransformerConfig(
        vocab_size=int(hf["n_words" if "n_words" in hf else "vocab_size"]), dim=dim,
        n_layers=int(hf["n_layers"]), n_heads=n_heads, n_kv_heads=n_heads, hidden_dim=4 * dim,
        norm_eps=float(hf.get("layer_norm_eps", 1e-12)), norm_type="layernorm", post_ln=True,
        final_norm=False, mlp_gated=False, mlp_bias=True,
        mlp_act="gelu_exact" if hf.get("gelu_activation", True) else "relu", qkv_bias=True,
        o_proj_bias=True, use_rope=False, learned_pos=int(hf.get("max_position_embeddings", 512)),
        embed_norm=True, tie_embeddings=True, lm_head_bias=True, remat=remat, dtype=dtype,
    )


def _hf_bitnet(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """BitNet: the llama graph with its two sub-norms (``sub_norms``: an
    RMSNorm over the merged heads before o_proj and one over the activation
    product before down_proj) and a gated relu^2 MLP; the projections are
    plain Linears (the ternary quantization is the quantizer's, not the
    graph's)."""
    bias = bool(hf.get("attention_bias", False))
    return _llama_lineage(
        hf, dtype, remat, norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        head_dim_override=_explicit_head_dim(hf), sub_norms=True,
        mlp_act=_hf_act(hf.get("hidden_act", "relu2")), qkv_bias=bias, o_proj_bias=bias,
        rope_theta=float(hf.get("rope_theta", 500000.0)),
    )


def _hf_xglm(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """XGLM: OPT-style biased pre-LN blocks with a final norm, a non-gated
    exact-GELU MLP, the sqrt(dim) embedding scale and fairseq's computed
    sinusoids at positions + 2 (no parameter).  An activation other than
    gelu is refused, as in the JAX package."""
    if hf.get("activation_function", "gelu") != "gelu":
        raise ValueError(f"xglm activation {hf.get('activation_function')!r} is not implemented, "
                         "as in the JAX package")
    n_heads = int(hf["attention_heads"])
    return TransformerConfig(
        vocab_size=int(hf["vocab_size"]), dim=int(hf["d_model"]), n_layers=int(hf["num_layers"]),
        n_heads=n_heads, n_kv_heads=n_heads, hidden_dim=int(hf["ffn_dim"]), norm_eps=1e-5,
        norm_type="layernorm", mlp_gated=False, mlp_bias=True, mlp_act="gelu_exact",
        qkv_bias=True, o_proj_bias=True, use_rope=False, sinusoidal_pos=True,
        scale_embeddings=bool(hf.get("scale_embedding", True)),
        tie_embeddings=bool(hf.get("tie_word_embeddings", True)), remat=remat, dtype=dtype,
    )


def _hf_ctrl(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """CTRL: pre-LN blocks at its fixed LayerNorm eps 1e-6, a biased relu
    MLP, the sqrt(dim) embedding scale, tensor2tensor's computed sinusoids
    at the positions themselves, a final norm and a tied head with a bias
    of its own (``tied_head_bias``)."""
    n_heads = int(hf["n_head"])
    return TransformerConfig(
        vocab_size=int(hf["vocab_size"]), dim=int(hf["n_embd"]), n_layers=int(hf["n_layer"]),
        n_heads=n_heads, n_kv_heads=n_heads, hidden_dim=int(hf["dff"]), norm_eps=1e-6,
        norm_type="layernorm", mlp_gated=False, mlp_bias=True, mlp_act="relu", qkv_bias=True,
        o_proj_bias=True, use_rope=False, sinusoidal_pos=True, sinusoidal_offset=0,
        sinusoidal_kind="t2t", scale_embeddings=True, tie_embeddings=True, lm_head_bias=True,
        remat=remat, dtype=dtype,
    )


def _hf_bloom(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """BLOOM: ALiBi in place of any position embedding, a LayerNorm over the
    word embeddings, biased q/k/v from the per-head fused
    ``query_key_value`` (GPT-NeoX's split on load), a biased tanh-GELU MLP
    of four times the width, tied.
    ``apply_residual_connection_post_layernorm`` is refused, as in the JAX
    package."""
    if hf.get("apply_residual_connection_post_layernorm"):
        raise ValueError("bloom apply_residual_connection_post_layernorm is not implemented, as "
                         "in the JAX package")
    dim = int(hf.get("hidden_size", hf.get("n_embed", 0)))
    n_heads = int(hf.get("n_head", hf.get("num_attention_heads", 0)))
    return TransformerConfig(
        vocab_size=int(hf["vocab_size"]), dim=dim,
        n_layers=int(hf.get("n_layer", hf.get("num_hidden_layers", 0))), n_heads=n_heads,
        n_kv_heads=n_heads, hidden_dim=4 * dim, norm_eps=float(hf.get("layer_norm_epsilon", 1e-5)),
        norm_type="layernorm", mlp_gated=False, mlp_bias=True, mlp_act="gelu_tanh",
        qkv_bias=True, o_proj_bias=True, use_rope=False, use_alibi=True, embed_norm=True,
        tie_embeddings=bool(hf.get("tie_word_embeddings", True)), remat=remat, dtype=dtype,
    )


def _hf_mpt(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """MPT: ALiBi (grouped kv heads by ``attn_config.kv_n_heads``), no bias
    anywhere (LayerNorms without an offset), the straight-thirds ``Wqkv``
    split on load, a non-gated exact-GELU MLP at ``expansion_ratio``,
    tied.  As in the JAX package it refuses ``alibi=False``, ``qk_ln``, a
    head count that is not a power of two (MPT's slopes differ from the
    ALiBi paper's there), ``alibi_bias_max`` other than 8 and
    ``no_bias=False``."""
    attn = hf.get("attn_config", {})
    if not attn.get("alibi", True):
        raise ValueError("mpt attn_config.alibi=False is not implemented, as in the JAX package")
    if attn.get("qk_ln"):
        raise ValueError("mpt attn_config.qk_ln is not implemented, as in the JAX package")
    n_heads = int(hf.get("n_heads", 0))
    if n_heads & (n_heads - 1):
        raise ValueError("mpt with n_heads not a power of 2 is not implemented, as in the JAX "
                         "package (mpt's gen_slopes interleave differently there)")
    if float(attn.get("alibi_bias_max", 8)) != 8.0:
        raise ValueError("mpt alibi_bias_max != 8 is not implemented, as in the JAX package")
    if not hf.get("no_bias", True):
        raise ValueError("mpt no_bias=False is not implemented, as in the JAX package")
    dim = int(hf["d_model"])
    return TransformerConfig(
        vocab_size=int(hf["vocab_size"]), dim=dim, n_layers=int(hf["n_layers"]), n_heads=n_heads,
        n_kv_heads=int(attn.get("kv_n_heads", n_heads)),
        hidden_dim=int(hf.get("expansion_ratio", 4)) * dim, norm_eps=1e-5, norm_type="layernorm",
        norm_bias=False, mlp_gated=False, mlp_act="gelu_exact", use_rope=False, use_alibi=True,
        tie_embeddings=True, remat=remat, dtype=dtype,
    )

def _hf_doge(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """Doge: the llama graph with per-head q/k RMSNorms, dynamic-mask
    attention (the per-kv-head key bias exp(A * softplus(dt_proj(v))),
    exact up to ``keep_window_size`` tokens) and learned residual scales;
    tied unless told otherwise.  The CDMoE variant (``is_moe``) and rope
    scalings other than the default are refused, as in the JAX package."""
    if hf.get("is_moe"):
        raise ValueError("doge CDMoE (is_moe=True) is not implemented, as in the JAX package")
    rs = hf.get("rope_scaling")
    if rs is not None and rs.get("rope_type", rs.get("type")) not in (None, "default"):
        raise ValueError(f"doge rope_scaling {rs!r} is not implemented, as in the JAX package")
    bias = bool(hf.get("attention_bias", False))
    return _llama_lineage(
        hf, dtype, remat, norm_eps=float(hf.get("rms_norm_eps", 1e-6)),
        head_dim_override=_explicit_head_dim(hf), qk_norm=True,
        dyn_mask_keep_window=int(hf.get("keep_window_size", 2048)), residual_scales=True,
        mlp_act=_hf_act(hf.get("hidden_act", "silu")), mlp_bias=bool(hf.get("mlp_bias", False)),
        qkv_bias=bias, o_proj_bias=bias, tie_embeddings=bool(hf.get("tie_word_embeddings", True)),
    )


def _hf_diffllama(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """DiffLlama: the llama graph with differential attention
    (``DiffAttention``); ``attention_bias`` biases all four projections.
    An odd head count and ``rope_scaling`` are refused, as in the JAX
    package."""
    if hf.get("rope_scaling") is not None:
        raise ValueError("diffllama rope_scaling is not implemented, as in the JAX package")
    if int(hf["num_attention_heads"]) % 2:
        raise ValueError("differential attention needs an even head count, as in the JAX package")
    bias = bool(hf.get("attention_bias", False))
    return _llama_lineage(
        hf, dtype, remat, norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        head_dim_override=_explicit_head_dim(hf), diff_attention=True,
        mlp_act=_hf_act(hf.get("hidden_act", "silu")), qkv_bias=bias, o_proj_bias=bias,
    )


def _hf_mllama(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """Mllama's text path (Llama-3.2-Vision): the llama graph (GQA, llama3
    rope scaling, untied head) whose ``cross_attention_layers`` are
    ``SkipBlock``s, as HF's text model skips them when no vision states
    exist, so the layers keep HF's numbering; the embedding holds 8 more
    rows than the head has outputs.  Activations other than silu and rope
    types other than llama3 are refused, as in the JAX package."""
    _silu_only(hf, "mllama")
    cross = {int(i) for i in hf.get("cross_attention_layers") or ()}
    rs = hf.get("rope_scaling")
    rtype = None if rs is None else rs.get("rope_type", rs.get("type"))
    if rtype not in (None, "default", "llama3"):
        raise ValueError(f"mllama rope_type {rtype!r} is not implemented, as in the JAX package")
    n_layers = int(hf["num_hidden_layers"])
    return _llama_lineage(
        hf, dtype, remat, norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        rope_theta=float(hf.get("rope_theta", 500000.0)),
        rope_llama3_scaling=_llama3_scaling(rs) if rtype == "llama3" else None,
        layer_types=tuple("skip" if i in cross else "full_attention" for i in range(n_layers)),
        embed_vocab_size=int(hf["vocab_size"]) + 8,
    )


def _hf_moshi(hf: dict, dtype: torch.dtype, remat: bool) -> TransformerConfig:
    """Moshi's temporal transformer (MoshiForCausalLM): the llama graph with
    its fused gating ``fc1`` split into [gate | up] on load (so the MLP is
    ``ffn_dim // 2`` wide), one more embedding row than the head has
    outputs and rms eps 1e-8.  Its always-on sliding window is logged and
    not applied: full causal attention, exact within it, as in the JAX
    package.  Only silu is built."""
    _silu_only(hf, "moshi")
    dim, n_heads = int(hf["hidden_size"]), int(hf["num_attention_heads"])
    if hf.get("sliding_window"):
        logger.info(
            "moshi sliding_window=%s: full causal attention is used; keep sequences within the "
            "window for exactness", hf["sliding_window"],
        )
    head_dim = hf.get("head_dim")
    return TransformerConfig(
        vocab_size=int(hf["vocab_size"]), dim=dim, n_layers=int(hf["num_hidden_layers"]),
        n_heads=n_heads, n_kv_heads=int(hf.get("num_key_value_heads") or n_heads),
        hidden_dim=int(hf["ffn_dim"]) // 2,
        head_dim_override=(
            int(head_dim) if head_dim and int(head_dim) != dim // n_heads else None
        ),
        norm_eps=float(hf.get("rms_norm_eps", 1e-8)),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        embed_vocab_size=int(hf["vocab_size"]) + 1,
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)), remat=remat, dtype=dtype,
    )


# the beyond-llama model types' constructors (JAX transformer.py:361-443:
# the seven of its list of supported families, the GPT lineage, the llama
# lineage with knobs of its own, the dense decoders with a position or norm
# knob of their own, then those with a mixer of their own and the mllama
# and moshi text paths)
_BEYOND_LLAMA = {
    "gpt2": _hf_gpt2, "gpt_neox": _hf_gpt_neox, "falcon": _hf_falcon,
    "starcoder2": _hf_starcoder2, "stablelm": _hf_stablelm, "granite": _hf_granite,
    "cohere": _hf_cohere, "gptj": _hf_gptj, "codegen": _hf_codegen, "gpt_neo": _hf_gpt_neo,
    "gpt_bigcode": _hf_gpt_bigcode, "opt": _hf_opt, "openai-gpt": _hf_openai_gpt,
    "imagegpt": _hf_imagegpt, "olmo": _hf_olmo, "nemotron": _hf_nemotron,
    "persimmon": _hf_persimmon, "ernie4_5": _hf_ernie4_5, "arcee": _hf_arcee,
    "seed_oss": _hf_seed_oss, "exaone4": _hf_exaone4, "vaultgemma": _hf_vaultgemma,
    "apertus": _hf_apertus, "hunyuan_v1_dense": _hf_hunyuan_dense, "helium": _hf_helium,
    "open-llama": _hf_open_llama, "cohere2": _hf_cohere2,
    "gpt_neox_japanese": _hf_gpt_neox_japanese, "biogpt": _hf_biogpt, "xlm": _hf_xlm,
    "bitnet": _hf_bitnet, "xglm": _hf_xglm, "ctrl": _hf_ctrl, "bloom": _hf_bloom, "mpt": _hf_mpt,
    "doge": _hf_doge, "diffllama": _hf_diffllama, "mllama_text_model": _hf_mllama,
    "moshi": _hf_moshi,
}


class RMSNorm(torch.nn.Module):
    """RMSNorm in f32, cast back to x's dtype.  ``plus_one`` is gemma's
    flavour: y * (1 + w), w zero-initialized; the stored weight is HF's raw
    value."""

    def __init__(
        self, dim: int, eps: float, dtype: torch.dtype, device: Any, plus_one: bool = False
    ) -> None:
        super().__init__()
        init = torch.zeros if plus_one else torch.ones
        self.weight = torch.nn.Parameter(init(dim, dtype=dtype, device=device))
        self.eps = eps
        self.plus_one = plus_one

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        w = self.weight.to(torch.float32)
        return (y * (w + 1.0 if self.plus_one else w)).to(x.dtype)


class LayerNorm(torch.nn.Module):
    """LayerNorm in f32, cast back to x's dtype (the JAX package's
    ``nn.LayerNorm``): weight ones, offset ``bias`` zeros, or none with
    ``bias=False`` (Cohere's).  ``plus_one`` is Nemotron's LayerNorm1P, y *
    (w + 1) + b with w zero-initialized (the stored weight is HF's raw
    value); ``affine=False`` (OLMo's) has neither weight nor bias, so no
    state-dict key."""

    def __init__(
        self, dim: int, eps: float, dtype: torch.dtype, device: Any, bias: bool = True,
        plus_one: bool = False, affine: bool = True,
    ) -> None:
        super().__init__()
        init = torch.zeros if plus_one else torch.ones
        self.register_parameter(
            "weight",
            torch.nn.Parameter(init(dim, dtype=dtype, device=device)) if affine else None,
        )
        self.register_parameter(
            "bias",
            torch.nn.Parameter(torch.zeros(dim, dtype=dtype, device=device))
            if bias and affine else None,
        )
        self.eps = eps
        self.plus_one = plus_one

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            w = self.weight.to(torch.float32)
            y = y * (w + 1.0 if self.plus_one else w)
        if self.bias is not None:
            y = y + self.bias.to(torch.float32)
        return y.to(x.dtype)


def _block_norm(cfg: TransformerConfig, device: Any) -> torch.nn.Module:
    """A block's (and the final) norm of width dim, by ``norm_type`` (the
    JAX package's ``_make_block_norm``)."""
    if cfg.norm_type == "layernorm":
        return LayerNorm(cfg.dim, cfg.norm_eps, cfg.dtype, device, cfg.norm_bias,
                         plus_one=cfg.norm_plus_one, affine=not cfg.norm_no_affine)
    if cfg.norm_type != "rmsnorm":
        raise ValueError(f"norm_type={cfg.norm_type!r}")
    return RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype, device, cfg.norm_plus_one)


def _scalar(value: float, dtype: torch.dtype) -> torch.Tensor:
    """``value`` rounded to ``dtype``, as a 0-dim host tensor (a scalar to
    any device's tensor), as the JAX model's ``jnp.asarray(value, dtype)``."""
    return torch.tensor(value, dtype=dtype)


def _positions(b: int, s: int, start: Any, device: Any) -> torch.Tensor:
    """(b, s) absolute positions ``start + arange(s)``; ``start`` is an int
    or a per-row (b,) tensor (ragged decode)."""
    steps = torch.arange(s, device=device)
    if isinstance(start, torch.Tensor):
        return start.to(device=device, dtype=torch.int64)[:, None] + steps[None, :]
    return (start + steps).expand(b, s)


def alibi_slopes(n_heads: int) -> np.ndarray:
    """Per-head ALiBi slopes as float32 (the JAX package's ``alibi_slopes``,
    HF bloom's ``build_alibi_tensor``): 2^(-8 i / n) for i in 1..n at a
    power-of-two head count n; otherwise the slopes of the largest power of
    two below it, then every other slope of the table at twice that power
    (BLOOM-176B's 112 heads)."""

    def pow2_slopes(n: int) -> list[float]:
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        return np.asarray(pow2_slopes(n_heads), np.float32)
    base = 2 ** math.floor(math.log2(n_heads))
    extra = pow2_slopes(2 * base)[0::2][: n_heads - base]
    return np.asarray(pow2_slopes(base) + extra, np.float32)


def sinusoidal_positions(positions: torch.Tensor, dim: int, kind: str = "fairseq") -> torch.Tensor:
    """The computed position table at ``positions`` (any shape), in f32:
    angles position * exp(-i c) for i < dim / 2, sin and cos concatenated
    (not interleaved).  ``kind`` "fairseq" (XGLM) takes c = log(1e4) /
    (dim / 2 - 1), "t2t" (tensor2tensor's, CTRL) c = 2 log(1e4) / dim; the
    JAX package's ``_sinusoidal_positions`` / ``_t2t_sinusoidal_positions``.
    Callers add their offset to the positions."""
    if dim % 2:
        raise ValueError("sinusoidal positions require an even dim")
    if kind not in ("fairseq", "t2t"):
        raise ValueError(f"sinusoidal_kind={kind!r}")
    half = dim // 2
    log_1e4 = torch.log(torch.tensor(10000.0, dtype=torch.float32))
    step = log_1e4 * 2.0 / dim if kind == "t2t" else log_1e4 / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32) * -step).to(positions.device)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def yarn_parameters(
    head_dim: int, theta: float, scaling: dict, max_pos: int
) -> tuple[tuple, float]:
    """Yarn inverse frequencies and attention factor (HF
    ``_compute_yarn_parameters``, the JAX package's ``yarn_parameters``):
    low frequencies interpolated by ``factor``, high ones extrapolated, a
    linear ramp between the beta_fast / beta_slow rotation boundaries; the
    attention factor 0.1 * mscale * ln(factor) + 1 unless given.  Computed
    in float64 and returned as plain floats."""
    factor = float(scaling["factor"])
    attention_factor = scaling.get("attention_factor")
    mscale = scaling.get("mscale")
    mscale_all_dim = scaling.get("mscale_all_dim")
    original_max = int(scaling.get("original_max_position_embeddings") or max_pos)

    def get_mscale(scale: float, m: float = 1.0) -> float:
        return 0.1 * m * math.log(scale) + 1.0 if scale > 1 else 1.0

    if attention_factor is None:
        if mscale and mscale_all_dim:
            attention_factor = get_mscale(factor, mscale) / get_mscale(factor, mscale_all_dim)
        else:
            attention_factor = get_mscale(factor)
    beta_fast = float(scaling.get("beta_fast") or 32.0)
    beta_slow = float(scaling.get("beta_slow") or 1.0)

    def correction_dim(num_rotations: float) -> float:
        return (head_dim * math.log(original_max / (num_rotations * 2 * math.pi))) / (
            2 * math.log(theta)
        )

    low, high = correction_dim(beta_fast), correction_dim(beta_slow)
    if bool(scaling.get("truncate", True)):
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0.0), min(high, head_dim - 1)
    if low == high:
        high += 0.001
    inv_freq = []
    for i in range(head_dim // 2):
        pos_freq = theta ** (2 * i / head_dim)
        extrap, interp = 1.0 / pos_freq, 1.0 / (factor * pos_freq)
        extrap_factor = 1.0 - min(max((i - low) / (high - low), 0.0), 1.0)
        inv_freq.append(float(interp * (1 - extrap_factor) + extrap * extrap_factor))
    return tuple(inv_freq), float(attention_factor)


def _longrope_short_factor(hf: dict, rs: dict, rot_dim: int, theta: float) -> tuple[tuple, float]:
    """phi3's longrope in its short-factor regime: HF takes short_factor
    while the sequence stays within original_max_position_embeddings, the
    regime the calibration loaders keep to; the attention factor
    sqrt(1 + ln f / ln orig) applies at every length."""
    short = [float(v) for v in rs["short_factor"]]
    orig = int(hf.get("original_max_position_embeddings") or hf.get("max_position_embeddings", 4096))
    lr_factor = float(hf.get("max_position_embeddings", orig)) / orig
    af = rs.get("attention_factor")
    if af is None:
        af = 1.0 if lr_factor <= 1.0 else math.sqrt(1 + math.log(lr_factor) / math.log(orig))
    logger.info(
        "phi3 longrope: short-factor frequencies (exact for sequences <= "
        "original_max_position_embeddings=%d)", orig,
    )
    return (
        tuple(float(1.0 / (short[i] * theta ** (2 * i / rot_dim))) for i in range(rot_dim // 2)),
        float(af),
    )


def _llama3_scale_freqs(inv_freq: torch.Tensor, scaling: tuple) -> torch.Tensor:
    """HF llama3 rope scaling (``_compute_llama3_parameters``): frequencies
    whose wavelength exceeds the original context are divided by
    ``factor``, high ones pass, the band between is interpolated.  It
    applies at every position, so Llama-3.1 / 3.2 logits need it."""
    factor, low_freq_factor, high_freq_factor, old_len = scaling
    wavelen = 2.0 * math.pi / inv_freq
    low_freq_wavelen = old_len / low_freq_factor
    high_freq_wavelen = old_len / high_freq_factor
    scaled = torch.where(wavelen > low_freq_wavelen, inv_freq / factor, inv_freq)
    smooth = (old_len / wavelen - low_freq_factor) / (high_freq_factor - low_freq_factor)
    smoothed = (1.0 - smooth) / factor * inv_freq + smooth * inv_freq
    is_medium = (wavelen >= high_freq_wavelen) & (wavelen <= low_freq_wavelen)
    return torch.where(is_medium, smoothed, scaled)


def _rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    theta: float,
    llama3_scaling: Optional[tuple] = None,
    yarn: Optional[tuple] = None,
    partial_dim: Optional[int] = None,
    interleaved: bool = False,
) -> torch.Tensor:
    """HF llama rotate-half rotary embedding at absolute ``positions``
    (b, s); x: (b, s, heads, hd).  ``yarn`` (inverse frequencies, attention
    factor) replaces the theta frequencies and scales cos and sin;
    ``llama3_scaling`` rescales the frequencies.  ``partial_dim`` rotates
    only the first that many dims of each head (the rest pass through, the
    frequencies' exponent over half of them) and ``interleaved`` rotates the
    pairs (0::2, 1::2) as GPT-J does: together GLM-4's rotary."""
    if partial_dim is not None and partial_dim < x.shape[-1]:
        rotated = _rope(x[..., :partial_dim], positions, theta, llama3_scaling, yarn,
                        interleaved=interleaved)
        return torch.cat([rotated, x[..., partial_dim:]], dim=-1)
    half = x.shape[-1] // 2
    attn_factor = 1.0
    if yarn is not None:
        inv_freq, attn_factor = yarn
        freqs = torch.tensor(inv_freq, dtype=torch.float32, device=x.device)
    else:
        freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    if llama3_scaling is not None:
        freqs = _llama3_scale_freqs(freqs, llama3_scaling)
    angles = positions[:, :, None].to(torch.float32) * freqs  # (b, s, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    if yarn is not None:
        cos, sin = cos * attn_factor, sin * attn_factor
    if interleaved:
        x1, x2 = x[..., 0::2].to(torch.float32), x[..., 1::2].to(torch.float32)
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).flatten(-2)
    else:
        x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class Attention(torch.nn.Module):
    """Grouped-query attention of layer ``layer_idx`` (the JAX package's
    ``Attention.create``): a layer ``layer_types`` marks
    "sliding_attention" sees the last ``sliding_window`` keys and, with a
    ``rope_local_theta`` (gemma3, olmo3), rotates at that theta unscaled; a
    layer ``rope_layers`` marks 0 is not rotated; the scale is
    ``query_scale_override ** -0.5`` where that is set."""

    def __init__(self, cfg: TransformerConfig, device: Any, layer_idx: int = 0) -> None:
        super().__init__()
        hd = cfg.head_dim
        kw = {"dtype": cfg.dtype, "device": device}
        self.q_proj = torch.nn.Linear(cfg.dim, cfg.n_heads * hd, bias=cfg.qkv_bias, **kw)
        self.k_proj = torch.nn.Linear(cfg.dim, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, **kw)
        self.v_proj = torch.nn.Linear(cfg.dim, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, **kw)
        self.o_proj = torch.nn.Linear(cfg.n_heads * hd, cfg.dim, bias=cfg.o_proj_bias, **kw)
        if cfg.qk_norm or cfg.qk_norm_flat:
            # Qwen3 and Gemma-3: per head, over head_dim; OLMo-2: over the
            # whole projection
            q_width, k_width = (
                (cfg.n_heads * hd, cfg.n_kv_heads * hd) if cfg.qk_norm_flat else (hd, hd)
            )
            self.q_norm, self.k_norm = (_qk_norm(cfg, w, device) for w in (q_width, k_width))
        else:
            self.q_norm = self.k_norm = None
        self.qk_norm_flat = cfg.qk_norm_flat
        self.clip_qkv = cfg.clip_qkv
        self.n_heads = cfg.n_heads
        self.n_kv_heads = cfg.n_kv_heads
        self.head_dim = hd
        sliding = (
            layer_idx < len(cfg.layer_types)
            and cfg.layer_types[layer_idx] == "sliding_attention"
        )
        local_rope = sliding and cfg.rope_local_theta is not None
        self.rope_theta = cfg.rope_local_theta if local_rope else cfg.rope_theta
        self.rope_yarn = None if local_rope else cfg.rope_yarn
        self.rope_llama3_scaling = cfg.rope_llama3_scaling
        self.use_rope = (
            bool(cfg.rope_layers[layer_idx]) if layer_idx < len(cfg.rope_layers) else cfg.use_rope
        )
        self.rope_partial_dim = (
            int(hd * cfg.rope_partial_factor) if cfg.rope_partial_factor is not None else None
        )
        self.rope_interleaved = cfg.rope_interleaved
        self.sliding_window = cfg.sliding_window if sliding else None
        self.logit_softcap = cfg.attn_logit_softcap
        self.scale_override = cfg.query_scale_override
        self.use_alibi = cfg.use_alibi
        self._alibi_by_device: dict = {}
        # bitnet: an RMSNorm over the merged heads, inside o_proj's input
        self.attn_sub_norm = (
            RMSNorm(cfg.n_heads * hd, cfg.norm_eps, cfg.dtype, device) if cfg.sub_norms else None
        )
        # doge: the dynamic-mask key bias's parameter (zeros, as HF and JAX
        # initialise it) and its projection of the merged kv-head values
        self.dyn_mask_keep_window = cfg.dyn_mask_keep_window
        doge = cfg.dyn_mask_keep_window is not None
        self.dyn_mask_A = (
            torch.nn.Parameter(torch.zeros(cfg.n_kv_heads, **kw)) if doge else None
        )
        self.dt_proj = (
            torch.nn.Linear(cfg.n_kv_heads * hd, cfg.n_kv_heads, bias=cfg.qkv_bias, **kw)
            if doge else None
        )

    @property
    def has_key_bias(self) -> bool:
        """ALiBi or doge's key bias: the flash kernel has no logit bias, so
        such a layer takes the plain paths (JAX transformer.py:4094-4096)."""
        return self.use_alibi or self.dt_proj is not None

    def dyn_mask_bias(self, v: torch.Tensor) -> torch.Tensor:
        """Doge's additive key bias exp(A * softplus(dt_proj(v))) in f32,
        (b, s, kv_heads), from the un-repeated values v (b, s, kv_heads,
        hd): a key's bias depends on its own value only, so the cached
        attention keeps it beside k and v."""
        b, s = v.shape[:2]
        dt = self.dt_proj(v.reshape(b, s, -1))
        return torch.exp(self.dyn_mask_A.to(torch.float32) * F.softplus(dt.to(torch.float32)))

    def scale(self, hd: int) -> float:
        """The softmax scale at head dim ``hd``."""
        return (self.scale_override if self.scale_override is not None else hd) ** -0.5

    def rope(self, t: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        if not self.use_rope:
            return t
        return _rope(t, positions, self.rope_theta, self.rope_llama3_scaling, self.rope_yarn,
                     self.rope_partial_dim, self.rope_interleaved)

    def project_qkv(
        self, x: torch.Tensor, positions: Optional[torch.Tensor] = None
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Projections (with their biases), the flat q/k norms, the
        ``clip_qkv`` clamp, the per-head q/k norms and rope at absolute
        ``positions`` (b, s; arange when None): q (b, s, heads, hd) and k, v
        (b, s, kv_heads, hd), before any GQA repeat.  The cached attention
        (``serving.py``) reuses it."""
        b, s, _ = x.shape
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        hd = q.shape[-1] // self.n_heads  # robust to decomposed projections
        if self.q_norm is not None and self.qk_norm_flat:
            q, k = self.q_norm(q), self.k_norm(k)
        if self.clip_qkv is not None:
            q, k, v = (torch.clamp(t, -self.clip_qkv, self.clip_qkv) for t in (q, k, v))
        q = q.reshape(b, s, self.n_heads, hd)
        k = k.reshape(b, s, self.n_kv_heads, hd)
        v = v.reshape(b, s, self.n_kv_heads, hd)
        if self.q_norm is not None and not self.qk_norm_flat:
            q, k = self.q_norm(q), self.k_norm(k)
        if positions is None:
            positions = _positions(b, s, 0, x.device)
        return self.rope(q, positions), self.rope(k, positions), v

    def finish(self, merged: torch.Tensor) -> torch.Tensor:
        """The output projection of the merged heads (b, s, heads * hd),
        after bitnet's ``attn_sub_norm``."""
        if self.attn_sub_norm is not None:
            merged = self.attn_sub_norm(merged)
        return self.o_proj(merged)

    def alibi_slopes(self, device: Any) -> torch.Tensor:
        """The layer's (heads,) f32 ALiBi slopes on ``device``, copied there
        once: a host-to-device copy a call would make each cached decode
        step wait for the card."""
        device = torch.device(device)
        if device not in self._alibi_by_device:
            self._alibi_by_device[device] = torch.from_numpy(alibi_slopes(self.n_heads)).to(device)
        return self._alibi_by_device[device]

    def forward(
        self,
        x: torch.Tensor,
        attn_mask: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        b, s, _ = x.shape
        if positions is None:
            positions = _positions(b, s, 0, x.device)
        q, k, v = self.project_qkv(x, positions)
        hd = q.shape[-1]
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (b, heads, s, hd)
        scale = self.scale(hd)
        # ALiBi: slope_h * key position on head h's scaled logits (b, h, 1,
        # s), before any soft-cap and the mask (JAX transformer.py:4125-4130)
        key_bias = (
            self.alibi_slopes(x.device)[None, :, None, None]
            * positions.to(torch.float32)[:, None, None, :]
            if self.use_alibi else None
        )
        if self.dt_proj is not None:
            # doge: each kv head's bias repeated over its group, in the
            # order of JAX's jnp.repeat (transformer.py:4062-4078, :4121)
            if self.dyn_mask_keep_window is not None and s > self.dyn_mask_keep_window:
                raise ValueError(
                    f"doge top-k dynamic masking (seqlen {s} > keep_window_size "
                    f"{self.dyn_mask_keep_window}) is not implemented; keep calibration seqlen "
                    "within the window"
                )
            bias = self.dyn_mask_bias(v.transpose(1, 2)).transpose(1, 2)  # (b, kv_heads, s)
            key_bias = torch.repeat_interleave(bias, self.n_heads // self.n_kv_heads, dim=1)[
                :, :, None, :]
        if self.logit_softcap is not None or self.sliding_window is not None:
            out = _capped_windowed_attention(
                q, k, v, scale, attn_mask, self.logit_softcap, self.sliding_window, key_bias
            )
        elif not self.has_key_bias and _use_flash_kernel(q, attn_mask):
            out = flash_attention(q, k, v, scale)
        else:
            out = causal_attention_plain(q, k, v, scale, attn_mask, key_bias)
        return self.finish(out.transpose(1, 2).reshape(b, s, -1))


class DiffAttention(torch.nn.Module):
    """DiffLlama's differential attention of layer ``layer_idx`` (the JAX
    package's ``DiffAttention``, transformer.py:4273-4385): llama rope, one
    f32 softmax over all heads, the values paired feature-wise to 2 *
    head_dim after the group repeat; the first half of the heads' outputs
    minus lambda times the second half's, lambda = exp(lq1 . lk1) - exp(lq2
    . lk2) + lambda_init with lambda_init = 0.8 - 0.6 exp(-0.3 layer_idx),
    then an RMS norm with no affine over each 2 * head_dim group, scaled by
    1 - lambda_init, before o_proj.  The casts are JAX's: the
    probabilities are cast to the activation dtype before the value
    products, lambda is computed in f32 and cast, the norm runs in f32."""

    def __init__(self, cfg: TransformerConfig, device: Any, layer_idx: int = 0) -> None:
        super().__init__()
        hd = cfg.head_dim
        kw = {"dtype": cfg.dtype, "device": device}
        self.q_proj = torch.nn.Linear(cfg.dim, cfg.n_heads * hd, bias=cfg.qkv_bias, **kw)
        self.k_proj = torch.nn.Linear(cfg.dim, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, **kw)
        self.v_proj = torch.nn.Linear(cfg.dim, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, **kw)
        self.o_proj = torch.nn.Linear(cfg.n_heads * hd, cfg.dim, bias=cfg.o_proj_bias, **kw)
        # HF's lambda_std_dev 0.1 normals, drawn by ``init_weights``
        for name in ("lambda_q1", "lambda_k1", "lambda_q2", "lambda_k2"):
            setattr(self, name, torch.nn.Parameter(torch.zeros(hd, **kw)))
        self.n_heads = cfg.n_heads
        self.n_kv_heads = cfg.n_kv_heads
        self.head_dim = hd
        self.rope_theta = cfg.rope_theta
        self.lambda_init = 0.8 - 0.6 * math.exp(-0.3 * layer_idx)
        self.norm_eps = cfg.norm_eps

    def project_qkv(
        self, x: torch.Tensor, positions: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """q (b, s, heads, hd) and k, v (b, s, kv_heads, hd), q and k rotated
        at ``positions``; the cached form (``serving.py``) reuses it."""
        b, s, _ = x.shape
        q = self.q_proj(x)
        hd = q.shape[-1] // self.n_heads
        k = self.k_proj(x).reshape(b, s, self.n_kv_heads, hd)
        v = self.v_proj(x).reshape(b, s, self.n_kv_heads, hd)
        q = q.reshape(b, s, self.n_heads, hd)
        return _rope(q, positions, self.rope_theta), _rope(k, positions, self.rope_theta), v

    def lam(self, dtype: torch.dtype) -> torch.Tensor:
        """lambda, computed in f32 and cast to ``dtype``."""
        f32 = torch.float32
        lam1 = torch.exp(torch.sum(self.lambda_q1.to(f32) * self.lambda_k1.to(f32)))
        lam2 = torch.exp(torch.sum(self.lambda_q2.to(f32) * self.lambda_k2.to(f32)))
        return (lam1 - lam2 + self.lambda_init).to(dtype)

    def attend(
        self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor
    ) -> torch.Tensor:
        """The merged (b, s, heads * hd) output before o_proj of q (b, s,
        heads, hd) against k, v (b, t, kv_heads, hd), where ``valid`` (b or 1,
        s, t) marks the keys each query sees."""
        b, s, _, hd = q.shape
        dtype = q.dtype
        rep = self.n_heads // self.n_kv_heads
        if rep > 1:
            k, v = (torch.repeat_interleave(t, rep, dim=2) for t in (k, v))
        half = self.n_heads // 2
        vp = torch.cat([v[:, :, :half], v[:, :, half:]], dim=-1).to(torch.float32)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32))
        logits = logits * hd ** -0.5
        logits = logits.masked_fill(~valid[:, None], torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(dtype).to(torch.float32)
        o1 = torch.einsum("bhqk,bkhd->bqhd", probs[:, :half], vp).to(dtype)
        o2 = torch.einsum("bhqk,bkhd->bqhd", probs[:, half:], vp).to(dtype)
        of = (o1 - self.lam(dtype) * o2).to(torch.float32)
        rms = torch.rsqrt(torch.mean(torch.square(of), dim=-1, keepdim=True) + self.norm_eps)
        return ((of * rms) * (1.0 - self.lambda_init)).to(dtype).reshape(b, s, -1)

    def forward(
        self,
        x: torch.Tensor,
        attn_mask: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        b, s, _ = x.shape
        if positions is None:
            positions = _positions(b, s, 0, x.device)
        q, k, v = self.project_qkv(x, positions)
        valid = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()[None]
        if attn_mask is not None:
            valid = valid & attn_mask[:, None, :].to(torch.bool)
        return self.o_proj(self.attend(q, k, v, valid))


class MLAttention(torch.nn.Module):
    """DeepSeek-V2 / V3 multi-head latent attention (the JAX package's
    ``MLAttention``, transformer.py:4668-4820; HF's parameter names).
    Queries come from ``q_proj``, or through the bottleneck ``q_a_proj`` ->
    ``q_a_layernorm`` -> ``q_b_proj``; ``kv_a_proj_with_mqa`` gives a
    kv_lora_rank latent and one rope head shared by all heads, the latent
    is normed by ``kv_a_layernorm`` and expanded per head by ``kv_b_proj``
    into qk_nope key dims and v_head value dims.  Only the rope dims
    rotate, pair-interleaved in place (JAX's convention), with yarn over
    them; the scale is qk_head^-0.5 times ``mla_softmax_scale``.  Both lora
    norms keep eps 1e-6 whatever ``rms_norm_eps`` is, as HF builds them.
    The attention is a plain causal f32 softmax (no flash: two head dims),
    cast to the activation dtype before the value products.  Field order
    is the JAX module's, so the walk visits the sites in its order."""

    def __init__(self, cfg: TransformerConfig, device: Any, layer_idx: int = 0) -> None:
        super().__init__()
        kw = {"bias": False, "dtype": cfg.dtype, "device": device}
        h, nope, rope_d, v_d = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        lat = cfg.kv_lora_rank
        self.kv_a_proj_with_mqa = torch.nn.Linear(cfg.dim, lat + rope_d, **kw)
        self.kv_a_layernorm = RMSNorm(lat, 1e-6, cfg.dtype, device)
        self.kv_b_proj = torch.nn.Linear(lat, h * (nope + v_d), **kw)
        self.o_proj = torch.nn.Linear(h * v_d, cfg.dim, **kw)
        q_out = h * (nope + rope_d)
        if cfg.q_lora_rank is None:
            self.q_proj = torch.nn.Linear(cfg.dim, q_out, **kw)
            self.q_a_proj = self.q_a_layernorm = self.q_b_proj = None
        else:
            self.q_proj = None
            self.q_a_proj = torch.nn.Linear(cfg.dim, cfg.q_lora_rank, **kw)
            self.q_a_layernorm = RMSNorm(cfg.q_lora_rank, 1e-6, cfg.dtype, device)
            self.q_b_proj = torch.nn.Linear(cfg.q_lora_rank, q_out, **kw)
        self.n_heads = h
        self.qk_nope_head_dim, self.qk_rope_head_dim, self.v_head_dim = nope, rope_d, v_d
        self.kv_lora_rank = lat
        self.rope_theta = cfg.rope_theta
        self.rope_interleaved = cfg.rope_interleaved
        self.rope_yarn = cfg.rope_yarn
        self.softmax_scale_mult = (
            cfg.mla_softmax_scale if cfg.mla_softmax_scale is not None else 1.0)

    def scale(self) -> float:
        return (self.qk_nope_head_dim + self.qk_rope_head_dim) ** -0.5 * self.softmax_scale_mult

    def project(
        self, x: torch.Tensor, positions: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """q_nope (b, s, heads, nope), q_pe (b, s, heads, rope) rotated at
        ``positions``, the normed latent (b, s, kv_lora_rank) and the shared
        rope head (b, s, rope) rotated; the cached form (``serving.py``)
        caches the last two."""
        b, s, _ = x.shape
        if self.q_a_proj is not None:
            q = self.q_b_proj(self.q_a_layernorm(self.q_a_proj(x)))
        else:
            q = self.q_proj(x)
        q = q.reshape(b, s, self.n_heads, -1)
        q_nope, q_pe = q[..., : self.qk_nope_head_dim], q[..., self.qk_nope_head_dim:]
        ckv = self.kv_a_proj_with_mqa(x)
        lat = self.kv_a_layernorm(ckv[..., : self.kv_lora_rank])
        k_pe = ckv[..., self.kv_lora_rank:][:, :, None, :]
        q_pe, k_pe = (_rope(t, positions, self.rope_theta, yarn=self.rope_yarn,
                            interleaved=self.rope_interleaved) for t in (q_pe, k_pe))
        return q_nope, q_pe, lat, k_pe[:, :, 0]

    def forward(
        self,
        x: torch.Tensor,
        attn_mask: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        b, s, _ = x.shape
        if positions is None:
            positions = _positions(b, s, 0, x.device)
        q_nope, q_pe, lat, k_pe = self.project(x, positions)
        kv = self.kv_b_proj(lat).reshape(b, s, self.n_heads, -1)
        k_nope, v = kv[..., : self.qk_nope_head_dim], kv[..., self.qk_nope_head_dim:]
        qf = torch.cat([q_nope, q_pe], dim=-1).to(torch.float32)
        kf = torch.cat([k_nope, k_pe[:, :, None].expand(-1, -1, self.n_heads, -1)], dim=-1)
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf.to(torch.float32)) * self.scale()
        valid = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()[None, None]
        if attn_mask is not None:
            valid = valid & attn_mask[:, None, None, :].to(torch.bool)
        logits = logits.masked_fill(~valid, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(torch.float32), v.to(torch.float32))
        return self.o_proj(out.to(x.dtype).reshape(b, s, -1))


def _qk_norm(cfg: TransformerConfig, width: int, device: Any) -> torch.nn.Module:
    """A q or k norm (the JAX package's ``_make_qk_norm``): RMSNorm, or with
    ``qk_norm_type`` "layernorm" a LayerNorm with a bias (Persimmon's)."""
    if cfg.qk_norm_type == "layernorm":
        return LayerNorm(width, cfg.norm_eps, cfg.dtype, device)
    if cfg.qk_norm_type != "rmsnorm":
        raise ValueError(f"qk_norm_type={cfg.qk_norm_type!r}")
    return RMSNorm(width, cfg.norm_eps, cfg.dtype, device, cfg.norm_plus_one)


def _use_flash_kernel(q: torch.Tensor, attn_mask: Optional[torch.Tensor]) -> bool:
    """The model-level gate of transformer.py:4086-4117: bf16 on the card
    with no padding mask and a head_dim the kernel is built for (64, 96, 128
    or 256) takes the flash kernel (which reads the grouped k/v heads
    itself); everything else, an all-ones mask included, takes the einsum
    path.  ``Attention.forward`` also sends a soft-capped, windowed, ALiBi
    or doge layer to the einsum path, as the JAX gate does (the kernel has
    no logit bias)."""
    return (
        q.is_cuda
        and q.dtype == torch.bfloat16
        and attn_mask is None
        and q.shape[-1] in KERNEL_HEAD_DIMS
    )


def _capped_windowed_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    attn_mask: Optional[torch.Tensor],
    softcap: Optional[float],
    window: Optional[int],
    key_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The JAX model's einsum attention (transformer.py:4118-4162) with
    ``key_bias`` (ALiBi's, broadcast to (b, h, s, s)) added to the scaled
    f32 logits, Gemma-2's tanh soft-cap on them, then the causal mask
    narrowed to ``q - k < window`` (HF's convention, the query's own key
    included) and the padding mask; q (b, h, s, d), k and v (b, h_kv, s,
    d)."""
    h, s = q.shape[1], q.shape[2]
    rep = h // k.shape[1]
    if rep > 1:
        k, v = (torch.repeat_interleave(t, rep, dim=1) for t in (k, v))
    logits = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)) * scale
    if key_bias is not None:
        logits = logits + key_bias
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    idx = torch.arange(s, device=q.device)
    mask = idx[None, :] <= idx[:, None]
    if window is not None:
        mask = mask & (idx[:, None] - idx[None, :] < window)
    mask = mask[None, None]
    if attn_mask is not None:
        mask = mask & attn_mask[:, None, None, :].to(torch.bool)
    logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs.to(torch.float32), v.to(torch.float32)).to(q.dtype)


def _activation(name: str, h: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(h)
    if name == "gelu_tanh":
        return F.gelu(h, approximate="tanh")
    if name == "gelu_exact":
        return F.gelu(h)
    if name == "relu":
        return F.relu(h)
    if name == "relu2":  # Nemotron's, Persimmon's and Arcee's relu^2
        return torch.square(F.relu(h))
    return h * torch.sigmoid(1.702 * h)  # quick_gelu


def _xielu_alpha(value: float, device: Any) -> torch.nn.Parameter:
    """HF ``XIELUActivation``'s raw alpha, log(expm1(value)) in bf16, kept
    as an f32 (1,) parameter as the JAX MLP keeps it."""
    v = torch.tensor([value], dtype=torch.bfloat16)
    return torch.nn.Parameter(torch.log(torch.expm1(v)).to(device=device, dtype=torch.float32))


class MLP(torch.nn.Module):
    """Gated MLP down(act(gate(x)) * up(x)), act silu (SwiGLU) or tanh-GELU
    (gemma's GeGLU); with ``mlp_gated`` off down(act(up(x))) and no
    ``gate_proj`` (gpt2, gpt_neox, falcon, starcoder2: exact or tanh GELU,
    relu, quick_gelu; nemotron, persimmon, arcee: relu^2; apertus: xIELU,
    whose learned scalars ``act_alpha_p`` / ``act_alpha_n`` are the MLP's
    own f32 parameters, not Linear sites).  ``mlp_bias`` biases every
    projection."""

    def __init__(self, cfg: TransformerConfig, device: Any) -> None:
        super().__init__()
        kw = {"bias": cfg.mlp_bias, "dtype": cfg.dtype, "device": device}
        self.gate_proj = (
            torch.nn.Linear(cfg.dim, cfg.hidden_dim, **kw) if cfg.mlp_gated else None
        )
        self.up_proj = torch.nn.Linear(cfg.dim, cfg.hidden_dim, **kw)
        self.down_proj = torch.nn.Linear(cfg.hidden_dim, cfg.dim, **kw)
        if cfg.mlp_act not in ("silu", "gelu_tanh", "gelu_exact", "relu", "quick_gelu", "relu2",
                               "xielu"):
            raise ValueError(f"mlp_act={cfg.mlp_act!r}")
        self.act = cfg.mlp_act
        if self.act == "xielu":
            # HF's init: log(expm1(0.8)) and log(expm1(0.8 - beta)), beta 0.5
            self.act_alpha_p = _xielu_alpha(0.8, device)
            self.act_alpha_n = _xielu_alpha(0.3, device)
        # bitnet: an RMSNorm over the activation product, inside down_proj's
        # input
        self.ffn_sub_norm = (
            RMSNorm(cfg.hidden_dim, cfg.norm_eps, cfg.dtype, device) if cfg.sub_norms else None
        )

    def _act(self, h: torch.Tensor) -> torch.Tensor:
        if self.act != "xielu":
            return _activation(self.act, h)
        # the JAX MLP's xIELU (HF ``_xielu_python``): x > 0 -> alpha_p x^2 +
        # beta x, else (expm1(min(x, eps)) - x) alpha_n + beta x, alpha_p =
        # softplus(a_p) and alpha_n = beta + softplus(a_n), each softplus
        # rounded through bf16 as HF keeps them; in f32, cast back
        beta = 0.5
        eps = float(torch.tensor(-1e-6, dtype=torch.bfloat16))
        ap = F.softplus(self.act_alpha_p.float()).to(torch.bfloat16).float()
        an = beta + F.softplus(self.act_alpha_n.float()).to(torch.bfloat16).float()
        xf = h.float()
        pos = ap * xf * xf + beta * xf
        neg = (torch.expm1(torch.clamp(xf, max=eps)) - xf) * an + beta * xf
        return torch.where(xf > 0, pos, neg).to(h.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gate_proj is None:
            h = self._act(self.up_proj(x))
        else:
            h = self._act(self.gate_proj(x)) * self.up_proj(x)
        if self.ffn_sub_norm is not None:
            h = self.ffn_sub_norm(h)
        return self.down_proj(h)


def _use_int8_kernel(x: torch.Tensor) -> bool:
    """The int8 grouped kernel runs on the card, in bf16 (the JAX package's
    ``_use_int8_gmm``: on the TPU), at every row count.  The JAX package
    takes it only up to 512 rows (transformer.py:5401), a limit set on a
    TPU, where its padded kernel lost at prefill; on an H100 the kernel
    beats dequantizing every expert for the bf16 grouped kernel at 8, 16,
    512 and 4096 rows in both projections (chip_smoke.py's gmm_int8
    lines; PERF.md §6), so there is no limit."""
    return x.is_cuda and x.dtype == torch.bfloat16


def router_scores(mod: "MoEMLP", x: torch.Tensor) -> torch.Tensor:
    """The layer's f32 router scores over all experts: the router logits in
    f32 through a softmax, or a sigmoid (DeepSeek-V3)."""
    logits = mod.gate(x).to(torch.float32)
    if mod.score_func == "sigmoid":
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=-1)


def _top_k_ids(t: torch.Tensor, k: int) -> torch.Tensor:
    """The ids of the k largest entries of the last axis, in descending
    order, equal entries in index order (``lax.top_k``'s rule; the group
    limit zeroes many choices, so ties are real there)."""
    return torch.sort(t, dim=-1, descending=True, stable=True).indices[..., :k]


def _moe_select(mod: "MoEMLP", scores: torch.Tensor) -> torch.Tensor:
    """The top-k expert ids (the JAX package's ``_moe_routing``,
    transformer.py:4989-5008): the choice is the scores plus the
    selection-only ``gate_correction_bias``; with ``n_group`` > 1 only the
    best ``topk_group`` groups (scored by their max, or their top-2 sum)
    stay eligible, every other expert's choice set to 0.0, not -inf (JAX's
    and HF's rule: under negative biases a masked expert can outrank an
    eligible one)."""
    choice = scores
    if mod.gate_correction_bias is not None:
        choice = choice + mod.gate_correction_bias.to(torch.float32)
    if mod.n_group <= 1:
        return torch.topk(choice, mod.top_k, dim=-1).indices
    g = choice.reshape(*choice.shape[:-1], mod.n_group, -1)
    group_scores = (torch.topk(g, 2, dim=-1).values.sum(dim=-1) if mod.group_top2_sum
                    else g.amax(dim=-1))
    keep = torch.zeros_like(group_scores, dtype=torch.bool).scatter_(
        -1, _top_k_ids(group_scores, mod.topk_group), True)
    choice = torch.where(keep.repeat_interleave(g.shape[-1], dim=-1), choice, 0.0)
    return _top_k_ids(choice, mod.top_k)


def moe_combine_weights(mod: "MoEMLP", scores: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The f32 combine weights of experts ``idx`` (..., k) from the layer's
    raw ``scores`` (never the biased choice): renormalized where the layer's
    ``norm_topk`` is set (1e-20 added to the sum under sigmoid scores, HF
    V3's epsilon), then scaled by ``routed_scaling`` in f32."""
    vals = torch.gather(scores, -1, idx)
    if mod.norm_topk:
        denom = torch.sum(vals, dim=-1, keepdim=True)
        if mod.score_func == "sigmoid":
            denom = denom + 1e-20
        vals = vals / denom
    if mod.routed_scaling != 1.0:
        vals = vals * torch.tensor(mod.routed_scaling, dtype=torch.float32)
    return vals


def _moe_routing(
    mod: "MoEMLP", x: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k expert weights (f32) and ids (the JAX package's ``_moe_routing``
    but for its sparsemixer, llama4 and gpt_oss branches): the scores
    (``router_scores``), the ids (``_moe_select``) and their weights
    (``moe_combine_weights``).  Mixtral renormalizes; Qwen-MoE, OLMoE and
    DeepSeek by ``norm_topk_prob``."""
    scores = router_scores(mod, x)
    idx = _moe_select(mod, scores)
    return moe_combine_weights(mod, scores, idx), idx


class MoEMLP(torch.nn.Module):
    """Top-k routed mixture of SwiGLU experts (Mixtral, Qwen2-/Qwen3-MoE,
    OLMoE, DeepSeek), with the router at ``gate`` and experts at
    ``experts.E.{gate,up,down}_proj``; Qwen2-MoE's always-on
    ``shared_expert`` (an ``MLP``) adds its output scaled by
    sigmoid(``shared_expert_gate``(x)), a Linear from dim to 1, on every
    route, DeepSeek's unscaled.  ``_moe_routing`` picks the experts
    (DeepSeek-V3's f32 ``gate_correction_bias`` shifts the choice only).

    Three dispatch routes for the routed experts, as in the JAX package:

    * **grouped**: when every expert is a plain ``MLP`` of exact-type,
      bias-free ``nn.Linear`` (or uniformly ``QuantLinear``) projections
      with no hooks, the (token, slot) rows are sorted by expert and each
      projection is one grouped matmul: the bf16 kernel on the card, the
      plain per-expert product otherwise (f32).  int8 experts are
      dequantized into the activation dtype first;
    * **grouped int8**: int8 experts on the card take the int8 kernel,
      which reads the int8 grids directly;
    * **dense masked**: otherwise (hooked projections during calibration,
      decomposed factor pairs) every expert runs on all tokens with the
      unrouted ones zeroed, so a capture hook sees exactly the routed rows.

    The grouped routes never call the expert modules, so hooks on them would
    not fire: a hooked expert makes the layer take the dense route.  The
    shared expert is always called as a module, so its hooks fire on any
    route and leave the routed experts' route as it is."""

    def __init__(self, cfg: TransformerConfig, device: Any) -> None:
        super().__init__()
        self.gate = torch.nn.Linear(
            cfg.dim, cfg.n_experts, bias=False, dtype=cfg.dtype, device=device
        )
        expert_cfg = dataclasses.replace(cfg, hidden_dim=cfg.moe_hidden_dim or cfg.hidden_dim)
        self.experts = torch.nn.ModuleList(MLP(expert_cfg, device) for _ in range(cfg.n_experts))
        self.shared_expert = self.shared_expert_gate = None
        if cfg.shared_expert_hidden_dim is not None:
            self.shared_expert = MLP(
                dataclasses.replace(cfg, hidden_dim=cfg.shared_expert_hidden_dim), device)
            if cfg.shared_expert_gated:
                self.shared_expert_gate = torch.nn.Linear(
                    cfg.dim, 1, bias=False, dtype=cfg.dtype, device=device)
        # DeepSeek-V3: the selection-only per-expert bias, held in f32 whatever
        # the model's dtype (a bf16 copy would change which experts win;
        # JAX transformer.py:5445-5451)
        self.gate_correction_bias = (
            torch.nn.Parameter(torch.zeros(cfg.n_experts, dtype=torch.float32, device=device))
            if cfg.router_correction_bias else None
        )
        if cfg.router_score_func not in ("softmax", "sigmoid"):
            raise ValueError(f"router_score_func={cfg.router_score_func!r}")
        self.top_k = cfg.n_experts_per_tok
        self.norm_topk = cfg.norm_topk_prob
        self.score_func = cfg.router_score_func
        self.n_group, self.topk_group = cfg.router_n_group, cfg.router_topk_group
        self.group_top2_sum = cfg.router_group_top2_sum
        self.routed_scaling = cfg.routed_scaling_factor

    def _experts_are_pristine(self) -> bool:
        ok = (torch.nn.Linear, QuantLinear)
        type_sig = None
        for e in self.experts:
            if type(e) is not MLP:
                return False
            projs = (e.gate_proj, e.up_proj, e.down_proj)
            if any(type(p) not in ok or p.bias is not None for p in projs):
                return False
            if any(m._forward_hooks or m._forward_pre_hooks for m in (e, *projs)):
                return False
            sig = tuple(type(p) for p in projs)
            if type_sig is None:
                type_sig = sig
            elif sig != type_sig:
                return False
        return True

    def _routing(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return _moe_routing(self, x)

    def _sort_by_expert(self, x: torch.Tensor):
        """Route, then sort the (token, slot) rows by expert with a stable
        sort.  Returns (xg, w_sorted, order, group_sizes), ``order`` the
        sorted rows' (token, slot) positions; nothing here waits for the
        card."""
        n_experts = len(self.experts)
        xf = x.reshape(-1, x.shape[-1])
        top_vals, top_idx = self._routing(xf)
        expert_ids = top_idx.reshape(-1)  # row-major by token
        order = torch.argsort(expert_ids, stable=True)
        group_sizes = torch.zeros(n_experts, dtype=torch.int32, device=x.device)
        group_sizes.scatter_add_(0, expert_ids, torch.ones_like(expert_ids, dtype=torch.int32))
        w_sorted = top_vals.reshape(-1)[order].to(x.dtype)
        return xf[order // self.top_k], w_sorted, order, group_sizes

    def _combine(
        self, x: torch.Tensor, y: torch.Tensor, w_sorted: torch.Tensor, order: torch.Tensor
    ) -> torch.Tensor:
        """Each token's sum of its top-k weighted expert rows.  The rows go
        back to (token, slot) order and each token's k rows are summed in
        slot order, so the sum is the same every run; an atomic scatter-add
        (``index_add_`` on the card) adds three or more rows in a varying
        order, and in bf16 their roundings then vary."""
        yw = torch.empty_like(y)
        yw[order] = y * w_sorted[:, None]
        return yw.view(-1, self.top_k, y.shape[-1]).sum(dim=1).reshape(x.shape)

    def _expert_weights(self, proj: str, dtype: torch.dtype) -> list[torch.Tensor]:
        ws = []
        for e in self.experts:
            p = getattr(e, proj)
            ws.append(p.dequantized(dtype) if isinstance(p, QuantLinear) else p.weight)
        return ws

    def _grouped(self, x: torch.Tensor) -> torch.Tensor:
        xg, w_sorted, order, group_sizes = self._sort_by_expert(x)
        # the JAX dtype rule (transformer.py:5201-5205): bf16 takes the
        # kernel (on a CUDA tensor), f32 the plain grouped product
        gdot = grouped_matmul if xg.dtype == torch.bfloat16 else grouped_matmul_plain
        g = gdot(xg, self._expert_weights("gate_proj", x.dtype), group_sizes)
        u = gdot(xg, self._expert_weights("up_proj", x.dtype), group_sizes)
        y = gdot(F.silu(g) * u, self._expert_weights("down_proj", x.dtype), group_sizes)
        return self._combine(x, y, w_sorted, order)

    def _grouped_int8(self, x: torch.Tensor) -> torch.Tensor:
        """The int8 kernel on each projection, reading the int8 grids of the
        sorted rows' experts directly (no dequantized copy)."""
        xg, w_sorted, order, group_sizes = self._sort_by_expert(x)

        def gdot(a: torch.Tensor, proj: str) -> torch.Tensor:
            ps = [getattr(e, proj) for e in self.experts]
            return grouped_matmul_int8(
                a, [p.weight_q for p in ps], [p.scale for p in ps], group_sizes
            )

        h = F.silu(gdot(xg, "gate_proj")) * gdot(xg, "up_proj")
        return self._combine(x, gdot(h, "down_proj"), w_sorted, order)

    def _dense_masked(self, x: torch.Tensor) -> torch.Tensor:
        top_vals, top_idx = self._routing(x)
        onehot = F.one_hot(top_idx, len(self.experts)).to(torch.float32)
        w = torch.einsum("...ke,...k->...e", onehot, top_vals).to(x.dtype)
        out = torch.zeros_like(x)
        for e, expert in enumerate(self.experts):
            w_e = w[..., e : e + 1]
            x_e = torch.where(w_e > 0, x, torch.zeros_like(x))
            out = out + expert(x_e) * w_e
        return out

    def _routed(self, x: torch.Tensor) -> torch.Tensor:
        if not self._experts_are_pristine():
            return self._dense_masked(x)
        quant = type(self.experts[0].gate_proj) is QuantLinear
        if quant and _use_int8_kernel(x):
            return self._grouped_int8(x)
        return self._grouped(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self._routed(x)
        if self.shared_expert is None:
            return out
        shared = self.shared_expert(x)
        if self.shared_expert_gate is not None:
            # the gate's Linear in x's dtype, its sigmoid in f32, cast back
            # (JAX transformer.py:5414-5417)
            shared = shared * torch.sigmoid(self.shared_expert_gate(x).to(torch.float32)).to(
                x.dtype)
        return out + shared


class Block(torch.nn.Module):
    """Pre-norm block; with ``sandwich_norms`` (gemma2 / gemma3 / glm4)
    ``post_attention_layernorm`` norms the attention output and the MLP runs
    between ``pre_feedforward_layernorm`` and ``post_feedforward_layernorm``
    (HF's names, JAX transformer.py:5643-5646); with ``post_norm_only``
    (olmo2 / olmo3) there is no ``input_layernorm`` and the attention and MLP
    outputs are normed by ``post_attention_layernorm`` and
    ``post_feedforward_layernorm`` before their residual adds (:5640-5642).
    A ``parallel_residual`` block returns x + attn(ln1 x) + mlp(mlp_in),
    mlp_in ``post_attention_layernorm(x)`` ("two_norm") or the shared
    ln1 x ("one_norm", which has no ``post_attention_layernorm``,
    :5633-5638); ``residual_multiplier`` (granite) scales both branches in
    x's dtype (:5647-5650); with ``post_ln`` (GPT-1) attention reads the
    raw stream and each norm follows its residual add, h =
    ``input_layernorm``(x + attn(x)), then ``post_attention_layernorm``(h +
    mlp(h)) (:5610-5613); with ``residual_scales`` (doge) h =
    ``input_residual`` * x + attn, then ``post_attention_residual`` * h +
    mlp(norm(h)) (:5651-5655).  ``diff_attention`` (diffllama) makes the
    mixer a ``DiffAttention``, ``kv_lora_rank`` (DeepSeek) an
    ``MLAttention``.  Norms are RMSNorm or LayerNorm by ``norm_type``."""

    def __init__(self, cfg: TransformerConfig, device: Any, layer_idx: int = 0) -> None:
        super().__init__()
        self.input_layernorm = None if cfg.post_norm_only else _block_norm(cfg, device)
        # the JAX rule (transformer.py:5710-5714): latent attention wherever
        # kv_lora_rank is set
        self.self_attn = (MLAttention if cfg.kv_lora_rank is not None
                          else DiffAttention if cfg.diff_attention else Attention)(
            cfg, device, layer_idx)
        self.post_attention_layernorm = (
            None if cfg.parallel_residual == "one_norm" else _block_norm(cfg, device)
        )
        self.pre_feedforward_layernorm = _block_norm(cfg, device) if cfg.sandwich_norms else None
        self.post_feedforward_layernorm = (
            _block_norm(cfg, device) if cfg.sandwich_norms or cfg.post_norm_only else None
        )
        self.mlp = MoEMLP(cfg, device) if cfg.layer_is_sparse(layer_idx) else MLP(cfg, device)
        if cfg.parallel_residual not in ("none", "one_norm", "two_norm"):
            raise ValueError(f"parallel_residual={cfg.parallel_residual!r}")
        self.parallel_residual = cfg.parallel_residual
        self.residual_multiplier = cfg.residual_multiplier
        self.post_ln = cfg.post_ln
        # doge: ones-initialised vectors scaling each add's residual term
        ones = (lambda: torch.nn.Parameter(torch.ones(cfg.dim, dtype=cfg.dtype, device=device)))
        self.input_residual = ones() if cfg.residual_scales else None
        self.post_attention_residual = ones() if cfg.residual_scales else None

    def forward(
        self,
        x: torch.Tensor,
        attn_mask: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
        self_attn: Optional[Any] = None,
    ) -> torch.Tensor:
        """``self_attn`` stands in for the block's attention when given (the
        cached attention of ``serving.forward_with_cache``)."""
        attn = self.self_attn if self_attn is None else self_attn
        if self.post_ln:
            h = self.input_layernorm(x + attn(x, attn_mask, positions))
            return self.post_attention_layernorm(h + self.mlp(h))
        if self.input_layernorm is None:  # post-norm-only
            h = x + self.post_attention_layernorm(attn(x, attn_mask, positions))
            return h + self.post_feedforward_layernorm(self.mlp(h))
        xin = self.input_layernorm(x)
        attn_out = attn(xin, attn_mask, positions)
        if self.parallel_residual != "none":
            one_norm = self.parallel_residual == "one_norm"
            return x + attn_out + self.mlp(xin if one_norm else self.post_attention_layernorm(x))
        if self.pre_feedforward_layernorm is not None:
            h = x + self.post_attention_layernorm(attn_out)
            return h + self.post_feedforward_layernorm(self.mlp(self.pre_feedforward_layernorm(h)))
        if self.residual_multiplier is not None:
            mult = _scalar(self.residual_multiplier, x.dtype)
            h = x + mult * attn_out
            return h + mult * self.mlp(self.post_attention_layernorm(h))
        if self.input_residual is not None:  # doge
            h = self.input_residual * x + attn_out
            return self.post_attention_residual * h + self.mlp(self.post_attention_layernorm(h))
        h = x + attn_out
        return h + self.mlp(self.post_attention_layernorm(h))


class SkipBlock(torch.nn.Module):
    """Identity stand-in for a whole layer the causal LM never runs (the JAX
    package's ``SkipBlock``): mllama's cross-attention layers, which HF's
    text model skips when no vision states exist.  It keeps HF's layer
    numbering, holds no parameter and no site, and has no cache entry."""

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None, self_attn: Any = None) -> torch.Tensor:
        return x


class PrunedSublayer(torch.nn.Module):
    """Zero-output stand-in for a block-pruned attention or MLP sublayer (the
    JAX package's ``PrunedSublayer``): with the residual add the block
    passes its input through.  It holds no parameter and no site."""

    def forward(self, x: torch.Tensor, *args: Any, **kwargs: Any) -> torch.Tensor:
        return torch.zeros_like(x)


def prune_blocks(model: "CausalLM", attn_indices: list[int], mlp_indices: list[int]) -> "CausalLM":
    """Block pruning: the attention sublayer of each block in
    ``attn_indices`` and the MLP of each in ``mlp_indices`` become
    ``PrunedSublayer``s, in place; returns the model (the JAX package's
    ``prune_blocks`` returns a new one).  Decomposition then walks the
    surviving sublayers only.  Every index is checked before any change."""
    layers = model.model.layers
    n = len(layers)
    for idx in list(attn_indices) + list(mlp_indices):
        if not 0 <= idx < n:
            raise ValueError(f"block index {idx} out of range [0, {n})")
        if not isinstance(layers[idx], Block):
            raise ValueError(f"block {idx} is a {type(layers[idx]).__name__}, which has no "
                             "sublayers to prune")
    for idx in attn_indices:
        layers[idx].self_attn = PrunedSublayer()
    for idx in mlp_indices:
        layers[idx].mlp = PrunedSublayer()
    return model


class Decoder(torch.nn.Module):
    def __init__(self, cfg: TransformerConfig, device: Any) -> None:
        super().__init__()
        # imagegpt's table has a row (its start token) the head does not
        # predict
        self.embed_tokens = torch.nn.Embedding(
            cfg.embed_vocab_size or cfg.vocab_size, cfg.dim, dtype=cfg.dtype, device=device
        )
        # mllama's cross-attention layers ("skip") are identities
        self.layers = torch.nn.ModuleList(
            SkipBlock() if i < len(cfg.layer_types) and cfg.layer_types[i] == "skip"
            else Block(cfg, device, i)
            for i in range(cfg.n_layers)
        )
        # GPT-1 has no final norm (and no ``model.norm`` keys, as in JAX)
        self.norm = _block_norm(cfg, device) if cfg.final_norm else torch.nn.Identity()
        # gpt2's learned absolute positions (HF wpe)
        self.pos_embed = (
            torch.nn.Embedding(cfg.learned_pos, cfg.dim, dtype=cfg.dtype, device=device)
            if cfg.learned_pos is not None else None
        )
        # open-llama's LayerNorm over the embedding (JAX Decoder.embed_norm)
        self.embed_norm = (
            LayerNorm(cfg.dim, cfg.norm_eps, cfg.dtype, device, cfg.norm_bias)
            if cfg.embed_norm else None
        )
        self.remat = cfg.remat
        self.scale_embeddings = cfg.scale_embeddings
        self.embedding_multiplier = cfg.embedding_multiplier
        # xglm / ctrl: the computed table's kind and offset (no parameter)
        self.sinusoid = (cfg.sinusoidal_kind, cfg.sinusoidal_offset) if cfg.sinusoidal_pos else None

    def embed_inputs(
        self, input_ids: torch.Tensor, positions: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Everything before the layer stack: the token embedding, scaled by
        sqrt(dim) for gemma (the factor computed in f32, cast to the
        activation dtype) or by granite's multiplier (in the activation
        dtype), then the learned position table at absolute ``positions``
        (b, s; arange when None), then the computed sinusoids at positions +
        ``sinusoidal_offset`` (f32, cast to the activation dtype), then the
        embedding norm (open-llama's, bloom's, xlm's), as the JAX decoder's
        ``embed_inputs``.  The cached forward (``serving.py``) reuses it with
        the positions offset by the cache fill."""
        x = self.embed_tokens(input_ids)
        if self.scale_embeddings:
            x = x * torch.tensor(x.shape[-1] ** 0.5, dtype=torch.float32).to(x.dtype)
        if self.embedding_multiplier is not None:
            x = x * _scalar(self.embedding_multiplier, x.dtype)
        if positions is None:
            positions = _positions(*input_ids.shape, 0, input_ids.device)
        if self.pos_embed is not None:
            x = x + self.pos_embed(positions)
        if self.sinusoid is not None:
            kind, offset = self.sinusoid
            x = x + sinusoidal_positions(positions + offset, x.shape[-1], kind).to(x.dtype)
        if self.embed_norm is not None:
            x = self.embed_norm(x)
        return x

    def forward(
        self, input_ids: torch.Tensor, attn_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        x = self.embed_inputs(input_ids)
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                x = _checkpointed(layer, x, attn_mask)
            else:
                x = layer(x, attn_mask)
        return self.norm(x)


def _checkpointed(layer: Block, x: torch.Tensor, attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """``layer(x, attn_mask)`` under ``torch.utils.checkpoint``: the block's
    activations are recomputed in the backward pass.  checkpoint replays
    the global RNG itself; a module's own ``generator`` (LoRA dropout) is
    rewound for the recompute and put back after it, so the recompute
    draws the forward's masks, as the JAX package's remat replays keys."""
    gens = [m.generator for m in layer.modules()
            if isinstance(getattr(m, "generator", None), torch.Generator)]

    def contexts():
        start = [g.get_state() for g in gens]

        @contextlib.contextmanager
        def replay():
            now = [g.get_state() for g in gens]
            for g, state in zip(gens, start):
                g.set_state(state)
            try:
                yield
            finally:
                for g, state in zip(gens, now):
                    g.set_state(state)

        return contextlib.nullcontext(), replay()

    return torch.utils.checkpoint.checkpoint(
        layer, x, attn_mask, use_reentrant=False, context_fn=contexts
    )


@torch.no_grad()
def init_weights(root: torch.nn.Module, gen: Optional[torch.Generator], device: Any) -> None:
    """The JAX package's initial distributions, drawn from ``gen`` (a fresh
    generator on ``device`` seeded 0 when None): Linear weights and biases
    uniform in +-1/sqrt(in_features), embeddings normal with std 0.02,
    diffllama's lambda vectors normal with std 0.1."""
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    for m in root.modules():
        if isinstance(m, torch.nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            m.weight.uniform_(-bound, bound, generator=gen)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=gen)
        elif isinstance(m, torch.nn.Embedding):
            m.weight.normal_(0.0, 0.02, generator=gen)
        elif isinstance(m, DiffAttention):
            for p in (m.lambda_q1, m.lambda_k1, m.lambda_q2, m.lambda_k2):
                p.normal_(0.0, 0.1, generator=gen)


class CausalLM(torch.nn.Module):
    """Callable with a batch dict {"input_ids", optional "attention_mask"}
    (or a bare id tensor), returning logits.  Weights are drawn from
    ``generator`` (a fresh one seeded 0 when None) with the JAX package's
    initial distributions.  ``lm_head_bias`` biases the untied head
    (``lm_head.bias``) or, tied, adds ``tied_head_bias`` (zeros at first, as
    in JAX) to the tied logits."""

    def __init__(
        self,
        cfg: TransformerConfig,
        device: Any = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.model = Decoder(cfg, device)
        kw = {"dtype": cfg.dtype, "device": device}
        self.lm_head = (
            None
            if cfg.tie_embeddings
            else torch.nn.Linear(cfg.dim, cfg.vocab_size, bias=cfg.lm_head_bias, **kw)
        )
        self.final_logit_softcap = cfg.final_logit_softcap
        self.logit_scale = cfg.logit_scale
        init_weights(self, generator, device)
        self.tied_head_bias = (
            torch.nn.Parameter(torch.zeros(cfg.vocab_size, **kw))
            if cfg.tie_embeddings and cfg.lm_head_bias else None
        )

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """Vocab logits of final-normed hidden states, multiplied by
        ``logit_scale`` (cohere, granite) and then soft-capped with tanh
        (gemma2), each in the logits' own dtype, in the JAX head's order."""
        if self.lm_head is None:
            logits = h @ self.model.embed_tokens.weight.t()
            if self.tied_head_bias is not None:
                logits = logits + self.tied_head_bias.to(logits.dtype)
        else:
            logits = self.lm_head(h)
        if self.logit_scale is not None:
            logits = logits * _scalar(self.logit_scale, logits.dtype)
        if self.final_logit_softcap is not None:
            cap = torch.tensor(self.final_logit_softcap, dtype=logits.dtype, device=logits.device)
            logits = cap * torch.tanh(logits / cap)
        return logits

    def forward(self, batch: Any) -> torch.Tensor:
        if isinstance(batch, dict):
            input_ids, attn_mask = batch["input_ids"], batch.get("attention_mask")
        else:
            input_ids, attn_mask = batch, None
        return self.head(self.model(input_ids, attn_mask))


def ce_loss(batch: dict[str, torch.Tensor], logits: torch.Tensor) -> torch.Tensor:
    """Shifted causal cross-entropy, mean over non-padding positions."""
    labels = batch["input_ids"][:, 1:]
    mask = batch.get("attention_mask")
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if mask is not None:
        m = mask[:, 1:].to(torch.float32)
        return -torch.sum(ll * m) / torch.clamp(torch.sum(m), min=1.0)
    return -torch.mean(ll)
