"""Decoder-only causal LM, llama family and Mixtral, in PyTorch.

Counterpart of the llama-family and Mixtral parts of
``ptdeco_tpu/models/transformer.py``: RMSNorm (optionally the gemma (1 + w)
flavour), HF rotate-half rope at absolute positions, grouped-query
attention (optionally with Qwen2's q/k/v biases and Qwen3's per-head q/k
RMSNorm), a gated MLP (SwiGLU, or gemma's tanh-GELU), the top-k routed
mixture of SwiGLU experts (``MoEMLP``), pre-norm blocks (optionally each
under ``torch.utils.checkpoint``, the config's ``remat``), an embedding
optionally scaled by sqrt(dim) (gemma), and a dict-in/logits-out
``CausalLM``.  Every projection is an ``nn.Linear`` site and parameter
names follow HF llama and the JAX package's MoE layout
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
    "Attention",
    "MLP",
    "MoEMLP",
    "Block",
    "Decoder",
    "CausalLM",
    "ce_loss",
    "HF_FAMILIES",
]

logger = logging.getLogger(__name__)


# the HF model types ``TransformerConfig.from_hf_config`` builds
HF_FAMILIES = ("llama", "mistral", "qwen2", "qwen3", "gemma", "mixtral")


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
    mlp_act: str = "silu"  # "silu" | "gelu_tanh"
    scale_embeddings: bool = False
    norm_plus_one: bool = False
    # Qwen3: a per-head RMSNorm on q and k before rope
    qk_norm: bool = False
    dtype: torch.dtype = torch.float32
    # Mixture of experts (Mixtral): n_experts > 0 replaces every block's MLP
    # with a top-k routed MoEMLP of SwiGLU experts of width hidden_dim, the
    # top-k weights always renormalized
    n_experts: int = 0
    n_experts_per_tok: int = 2
    # per-block gradient checkpointing (the JAX package's remat): each
    # block's activations are recomputed in the backward pass
    remat: bool = False

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.dim // self.n_heads

    @staticmethod
    def from_hf_config(
        hf: dict[str, Any], dtype: torch.dtype = torch.bfloat16, remat: bool = False
    ) -> "TransformerConfig":
        """HF ``config.json`` of a llama, mistral, qwen2, qwen3, gemma (first
        generation) or mixtral checkpoint -> config, as the JAX package's
        family branch builds it.  Raises ValueError on anything these
        families do not express here (rope scaling, other bias layouts,
        gemma2 / gemma3 and every other model type; ROADMAP.md lists them).
        A ``sliding_window`` (mistral, mixtral) is logged and not applied:
        full causal attention, exact for sequences within the window."""
        mt = hf.get("model_type", "llama")
        if mt not in HF_FAMILIES:
            raise ValueError(
                f"model_type={mt!r}: the port builds {list(HF_FAMILIES)} from a config.json "
                "(and phi through PhiConfig); the other families wait in ROADMAP.md"
            )
        rs = hf.get("rope_scaling")
        if rs is not None and rs.get("rope_type", rs.get("type")) not in (None, "default"):
            raise ValueError(
                f"rope_scaling {rs!r} is not implemented in the port (ROADMAP.md)"
            )
        # gemma configs carry hidden_activation (the authoritative field;
        # older snapshots say hidden_act "gelu" and run the tanh form)
        act = hf.get("hidden_activation") or hf.get("hidden_act", "silu")
        act_map = {"silu": "silu", "gelu": "gelu_tanh", "gelu_pytorch_tanh": "gelu_tanh"}
        if act not in act_map:
            raise ValueError(f"Unsupported hidden_act={act!r}")
        # qwen2's layout (biases on q/k/v, none on o_proj) is the only
        # attention bias expressed; llama / mistral with attention_bias also
        # bias o_proj, and mlp_bias biases gate/up/down
        if bool(hf.get("attention_bias", False)) and mt != "qwen2":
            raise ValueError(
                "attention_bias=True with an o_proj bias is not expressed (only "
                "qwen2's q/k/v-bias layout is); ROADMAP.md lists the other layouts"
            )
        if bool(hf.get("mlp_bias", False)):
            raise ValueError(
                "mlp_bias=True (biases on gate/up/down) is not expressed; ROADMAP.md lists it"
            )
        n_heads = int(hf["num_attention_heads"])
        dim = int(hf["hidden_size"])
        head_dim = hf.get("head_dim")
        override = (
            int(head_dim) if head_dim is not None and int(head_dim) * n_heads != dim else None
        )
        sliding = hf.get("sliding_window")
        if sliding is not None and hf.get("use_sliding_window", True):
            logger.info(
                "sliding_window=%s in config: full causal attention is used; keep "
                "sequences within the window for exactness", sliding,
            )
        gemma = mt == "gemma"
        return TransformerConfig(
            vocab_size=int(hf["vocab_size"]),
            dim=dim,
            n_layers=int(hf["num_hidden_layers"]),
            n_heads=n_heads,
            n_kv_heads=int(hf.get("num_key_value_heads", n_heads)),
            hidden_dim=int(hf["intermediate_size"]),
            norm_eps=float(hf.get("rms_norm_eps", 1e-6)),
            rope_theta=float(hf.get("rope_theta", 10000.0)),
            qkv_bias=bool(hf.get("attention_bias", mt == "qwen2")),
            tie_embeddings=bool(hf.get("tie_word_embeddings", gemma)),
            head_dim_override=override,
            mlp_act=act_map[act],
            scale_embeddings=gemma,
            norm_plus_one=gemma,
            qk_norm=mt == "qwen3",
            dtype=dtype,
            # HF MixtralSparseMoeBlock: softmax over all experts, top-k,
            # always renormalized; experts at intermediate_size
            n_experts=int(hf["num_local_experts"]) if mt == "mixtral" else 0,
            n_experts_per_tok=int(hf.get("num_experts_per_tok", 2)),
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


def _positions(b: int, s: int, start: Any, device: Any) -> torch.Tensor:
    """(b, s) absolute positions ``start + arange(s)``; ``start`` is an int
    or a per-row (b,) tensor (ragged decode)."""
    steps = torch.arange(s, device=device)
    if isinstance(start, torch.Tensor):
        return start.to(device=device, dtype=torch.int64)[:, None] + steps[None, :]
    return (start + steps).expand(b, s)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """HF llama rotate-half rotary embedding at absolute ``positions``
    (b, s); x: (b, s, heads, hd)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    angles = positions[:, :, None].to(torch.float32) * freqs  # (b, s, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class Attention(torch.nn.Module):
    def __init__(self, cfg: TransformerConfig, device: Any) -> None:
        super().__init__()
        hd = cfg.head_dim
        kw = {"dtype": cfg.dtype, "device": device}
        self.q_proj = torch.nn.Linear(cfg.dim, cfg.n_heads * hd, bias=cfg.qkv_bias, **kw)
        self.k_proj = torch.nn.Linear(cfg.dim, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, **kw)
        self.v_proj = torch.nn.Linear(cfg.dim, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, **kw)
        self.o_proj = torch.nn.Linear(cfg.n_heads * hd, cfg.dim, bias=False, **kw)
        if cfg.qk_norm:  # Qwen3: per head, over head_dim
            self.q_norm = RMSNorm(hd, cfg.norm_eps, cfg.dtype, device, cfg.norm_plus_one)
            self.k_norm = RMSNorm(hd, cfg.norm_eps, cfg.dtype, device, cfg.norm_plus_one)
        else:
            self.q_norm = self.k_norm = None
        self.n_heads = cfg.n_heads
        self.n_kv_heads = cfg.n_kv_heads
        self.head_dim = hd
        self.rope_theta = cfg.rope_theta

    def project_qkv(
        self, x: torch.Tensor, positions: Optional[torch.Tensor] = None
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Projections (with their biases), the per-head q/k norms and rope
        at absolute ``positions`` (b, s; arange when None): q (b, s, heads,
        hd) and k, v (b, s, kv_heads, hd), before any GQA repeat.  The
        cached attention (``serving.py``) reuses it."""
        b, s, _ = x.shape
        q = self.q_proj(x)
        hd = q.shape[-1] // self.n_heads  # robust to decomposed projections
        q = q.reshape(b, s, self.n_heads, hd)
        k = self.k_proj(x).reshape(b, s, self.n_kv_heads, hd)
        v = self.v_proj(x).reshape(b, s, self.n_kv_heads, hd)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        if positions is None:
            positions = _positions(b, s, 0, x.device)
        return _rope(q, positions, self.rope_theta), _rope(k, positions, self.rope_theta), v

    def finish(self, merged: torch.Tensor) -> torch.Tensor:
        """The output projection of the merged heads (b, s, heads * hd)."""
        return self.o_proj(merged)

    def forward(
        self,
        x: torch.Tensor,
        attn_mask: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        b, s, _ = x.shape
        q, k, v = self.project_qkv(x, positions)
        hd = q.shape[-1]
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (b, heads, s, hd)
        scale = hd ** -0.5
        if _use_flash_kernel(q, attn_mask):
            out = flash_attention(q, k, v, scale)
        else:
            out = causal_attention_plain(q, k, v, scale, attn_mask)
        return self.finish(out.transpose(1, 2).reshape(b, s, -1))


def _use_flash_kernel(q: torch.Tensor, attn_mask: Optional[torch.Tensor]) -> bool:
    """The model-level gate of transformer.py:4086-4117: bf16 on the card
    with no padding mask and a head_dim the kernel is built for (64, 128 or
    256) takes the flash kernel (which reads the grouped k/v heads itself);
    everything else, an all-ones mask included, takes the einsum path."""
    return (
        q.is_cuda
        and q.dtype == torch.bfloat16
        and attn_mask is None
        and q.shape[-1] in KERNEL_HEAD_DIMS
    )


class MLP(torch.nn.Module):
    """Gated MLP: down(act(gate(x)) * up(x)), act silu (SwiGLU) or tanh-GELU
    (gemma's GeGLU)."""

    def __init__(self, cfg: TransformerConfig, device: Any) -> None:
        super().__init__()
        kw = {"dtype": cfg.dtype, "device": device}
        self.gate_proj = torch.nn.Linear(cfg.dim, cfg.hidden_dim, bias=False, **kw)
        self.up_proj = torch.nn.Linear(cfg.dim, cfg.hidden_dim, bias=False, **kw)
        self.down_proj = torch.nn.Linear(cfg.hidden_dim, cfg.dim, bias=False, **kw)
        if cfg.mlp_act not in ("silu", "gelu_tanh"):
            raise ValueError(f"mlp_act={cfg.mlp_act!r}")
        self.act = cfg.mlp_act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.gate_proj(x)
        g = F.silu(g) if self.act == "silu" else F.gelu(g, approximate="tanh")
        return self.down_proj(g * self.up_proj(x))


def _use_int8_kernel(x: torch.Tensor) -> bool:
    """The int8 grouped kernel runs on the card, in bf16 (the JAX package's
    ``_use_int8_gmm``: on the TPU), at every row count.  The JAX package
    takes it only up to 512 rows (transformer.py:5401), a limit set on a
    TPU, where its padded kernel lost at prefill; on an H100 the kernel
    beats dequantizing every expert for the bf16 grouped kernel at 8, 16,
    512 and 4096 rows in both projections (chip_smoke.py's gmm_int8
    lines; PERF.md §6), so there is no limit."""
    return x.is_cuda and x.dtype == torch.bfloat16


def _moe_routing(
    gate: torch.nn.Module, x: torch.Tensor, top_k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k expert weights (f32) and ids: router logits in f32, softmax over
    all experts, top-k, renormalized (HF Mixtral)."""
    scores = torch.softmax(gate(x).to(torch.float32), dim=-1)
    top_vals, top_idx = torch.topk(scores, top_k, dim=-1)
    return top_vals / torch.sum(top_vals, dim=-1, keepdim=True), top_idx


class MoEMLP(torch.nn.Module):
    """Top-k routed mixture of SwiGLU experts (Mixtral), with the router at
    ``gate`` and experts at ``experts.E.{gate,up,down}_proj``.

    Three dispatch routes, as in the JAX package:

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
    not fire: a hooked expert makes the layer take the dense route."""

    def __init__(self, cfg: TransformerConfig, device: Any) -> None:
        super().__init__()
        self.gate = torch.nn.Linear(
            cfg.dim, cfg.n_experts, bias=False, dtype=cfg.dtype, device=device
        )
        self.experts = torch.nn.ModuleList(MLP(cfg, device) for _ in range(cfg.n_experts))
        self.top_k = cfg.n_experts_per_tok

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
        return _moe_routing(self.gate, x, self.top_k)

    def _sort_by_expert(self, x: torch.Tensor):
        """Route, then sort the (token, slot) rows by expert with a stable
        sort.  Returns (xg, w_sorted, tok_sorted, group_sizes); nothing here
        waits for the card."""
        n_experts = len(self.experts)
        xf = x.reshape(-1, x.shape[-1])
        top_vals, top_idx = self._routing(xf)
        expert_ids = top_idx.reshape(-1)  # row-major by token
        order = torch.argsort(expert_ids, stable=True)
        tok_sorted = order // self.top_k
        group_sizes = torch.zeros(n_experts, dtype=torch.int32, device=x.device)
        group_sizes.scatter_add_(0, expert_ids, torch.ones_like(expert_ids, dtype=torch.int32))
        w_sorted = top_vals.reshape(-1)[order].to(x.dtype)
        return xf[tok_sorted], w_sorted, tok_sorted, group_sizes

    def _combine(
        self, x: torch.Tensor, y: torch.Tensor, w_sorted: torch.Tensor, tok_sorted: torch.Tensor
    ) -> torch.Tensor:
        out = torch.zeros((tok_sorted.shape[0] // self.top_k, x.shape[-1]),
                          dtype=x.dtype, device=x.device)
        return out.index_add_(0, tok_sorted, y * w_sorted[:, None]).reshape(x.shape)

    def _expert_weights(self, proj: str, dtype: torch.dtype) -> list[torch.Tensor]:
        ws = []
        for e in self.experts:
            p = getattr(e, proj)
            ws.append(p.dequantized(dtype) if isinstance(p, QuantLinear) else p.weight)
        return ws

    def _grouped(self, x: torch.Tensor) -> torch.Tensor:
        xg, w_sorted, tok_sorted, group_sizes = self._sort_by_expert(x)
        # the JAX dtype rule (transformer.py:5201-5205): bf16 takes the
        # kernel (on a CUDA tensor), f32 the plain grouped product
        gdot = grouped_matmul if xg.dtype == torch.bfloat16 else grouped_matmul_plain
        g = gdot(xg, self._expert_weights("gate_proj", x.dtype), group_sizes)
        u = gdot(xg, self._expert_weights("up_proj", x.dtype), group_sizes)
        y = gdot(F.silu(g) * u, self._expert_weights("down_proj", x.dtype), group_sizes)
        return self._combine(x, y, w_sorted, tok_sorted)

    def _grouped_int8(self, x: torch.Tensor) -> torch.Tensor:
        """The int8 kernel on each projection, reading the int8 grids of the
        sorted rows' experts directly (no dequantized copy)."""
        xg, w_sorted, tok_sorted, group_sizes = self._sort_by_expert(x)

        def gdot(a: torch.Tensor, proj: str) -> torch.Tensor:
            ps = [getattr(e, proj) for e in self.experts]
            return grouped_matmul_int8(
                a, [p.weight_q for p in ps], [p.scale for p in ps], group_sizes
            )

        h = F.silu(gdot(xg, "gate_proj")) * gdot(xg, "up_proj")
        return self._combine(x, gdot(h, "down_proj"), w_sorted, tok_sorted)

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self._experts_are_pristine():
            return self._dense_masked(x)
        quant = type(self.experts[0].gate_proj) is QuantLinear
        if quant and _use_int8_kernel(x):
            return self._grouped_int8(x)
        return self._grouped(x)


class Block(torch.nn.Module):
    def __init__(self, cfg: TransformerConfig, device: Any) -> None:
        super().__init__()
        norm = (cfg.dim, cfg.norm_eps, cfg.dtype, device, cfg.norm_plus_one)
        self.input_layernorm = RMSNorm(*norm)
        self.self_attn = Attention(cfg, device)
        self.post_attention_layernorm = RMSNorm(*norm)
        self.mlp = MoEMLP(cfg, device) if cfg.n_experts > 0 else MLP(cfg, device)

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
        h = x + attn(self.input_layernorm(x), attn_mask, positions)
        return h + self.mlp(self.post_attention_layernorm(h))


class Decoder(torch.nn.Module):
    def __init__(self, cfg: TransformerConfig, device: Any) -> None:
        super().__init__()
        self.embed_tokens = torch.nn.Embedding(
            cfg.vocab_size, cfg.dim, dtype=cfg.dtype, device=device
        )
        self.layers = torch.nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_layers))
        self.norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype, device, cfg.norm_plus_one)
        self.remat = cfg.remat
        self.scale_embeddings = cfg.scale_embeddings

    def embed_inputs(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Everything before the layer stack: the token embedding, scaled by
        sqrt(dim) for gemma (the factor computed in f32, cast to the
        activation dtype, as the JAX decoder's ``embed_inputs``).  The
        cached forward (``serving.py``) reuses it."""
        x = self.embed_tokens(input_ids)
        if self.scale_embeddings:
            x = x * torch.tensor(x.shape[-1] ** 0.5, dtype=torch.float32).to(x.dtype)
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
    uniform in +-1/sqrt(in_features), embeddings normal with std 0.02."""
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


class CausalLM(torch.nn.Module):
    """Callable with a batch dict {"input_ids", optional "attention_mask"}
    (or a bare id tensor), returning logits.  Weights are drawn from
    ``generator`` (a fresh one seeded 0 when None) with the JAX package's
    initial distributions."""

    def __init__(
        self,
        cfg: TransformerConfig,
        device: Any = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.model = Decoder(cfg, device)
        self.lm_head = (
            None
            if cfg.tie_embeddings
            else torch.nn.Linear(cfg.dim, cfg.vocab_size, bias=False, dtype=cfg.dtype, device=device)
        )
        init_weights(self, generator, device)

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """Vocab logits of final-normed hidden states."""
        if self.lm_head is None:
            return h @ self.model.embed_tokens.weight.t()
        return self.lm_head(h)

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
