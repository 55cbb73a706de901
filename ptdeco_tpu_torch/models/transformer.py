"""Decoder-only causal LM, llama subset (Llama / TinyLlama), in PyTorch.

Counterpart of the llama part of ``ptdeco_tpu/models/transformer.py``:
RMSNorm, HF rotate-half rope, grouped-query attention, SwiGLU MLP,
pre-norm blocks, and a dict-in/logits-out ``CausalLM``.  Every projection
is an ``nn.Linear`` site and parameter names follow HF llama
(``model.layers.0.self_attn.q_proj.weight``), so decompose configs and
state dicts line up with the JAX package and with HF checkpoints.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..ops.flash_attention import KERNEL_HEAD_DIMS, causal_attention_plain, flash_attention

__all__ = [
    "TransformerConfig",
    "RMSNorm",
    "Attention",
    "MLP",
    "Block",
    "Decoder",
    "CausalLM",
    "ce_loss",
]


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
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def from_hf_config(
        hf: dict[str, Any], dtype: torch.dtype = torch.bfloat16
    ) -> "TransformerConfig":
        """HF ``config.json`` of a llama checkpoint -> config.  Raises
        ValueError on anything this llama subset does not express."""
        mt = hf.get("model_type", "llama")
        if mt != "llama":
            raise ValueError(f"model_type={mt!r}: this package has the llama subset only")
        if hf.get("rope_scaling") is not None:
            raise ValueError("rope_scaling is not implemented in the llama subset")
        if hf.get("hidden_act", "silu") != "silu":
            raise ValueError(f"Unsupported hidden_act={hf.get('hidden_act')!r}")
        if bool(hf.get("attention_bias", False)) or bool(hf.get("mlp_bias", False)):
            raise ValueError("attention_bias / mlp_bias are not expressed by the llama subset")
        n_heads = int(hf["num_attention_heads"])
        dim = int(hf["hidden_size"])
        head_dim = hf.get("head_dim")
        if head_dim is not None and int(head_dim) * n_heads != dim:
            raise ValueError("head_dim * num_attention_heads != hidden_size is not expressed")
        return TransformerConfig(
            vocab_size=int(hf["vocab_size"]),
            dim=dim,
            n_layers=int(hf["num_hidden_layers"]),
            n_heads=n_heads,
            n_kv_heads=int(hf.get("num_key_value_heads", n_heads)),
            hidden_dim=int(hf["intermediate_size"]),
            norm_eps=float(hf.get("rms_norm_eps", 1e-6)),
            rope_theta=float(hf.get("rope_theta", 10000.0)),
            tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
            dtype=dtype,
        )

    @staticmethod
    def tinyllama_1_1b(dtype: torch.dtype = torch.bfloat16) -> "TransformerConfig":
        return TransformerConfig(
            vocab_size=32000, dim=2048, n_layers=22, n_heads=32, n_kv_heads=4,
            hidden_dim=5632, dtype=dtype,
        )


class RMSNorm(torch.nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype, device: Any) -> None:
        super().__init__()
        self.weight = torch.nn.Parameter(torch.ones(dim, dtype=dtype, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (y * self.weight.to(torch.float32)).to(x.dtype)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """HF llama rotate-half rotary embedding; x: (b, s, heads, hd)."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    angles = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class Attention(torch.nn.Module):
    def __init__(self, cfg: TransformerConfig, device: Any) -> None:
        super().__init__()
        hd = cfg.head_dim
        kw = {"dtype": cfg.dtype, "device": device}
        self.q_proj = torch.nn.Linear(cfg.dim, cfg.n_heads * hd, bias=False, **kw)
        self.k_proj = torch.nn.Linear(cfg.dim, cfg.n_kv_heads * hd, bias=False, **kw)
        self.v_proj = torch.nn.Linear(cfg.dim, cfg.n_kv_heads * hd, bias=False, **kw)
        self.o_proj = torch.nn.Linear(cfg.n_heads * hd, cfg.dim, bias=False, **kw)
        self.n_heads = cfg.n_heads
        self.n_kv_heads = cfg.n_kv_heads
        self.rope_theta = cfg.rope_theta

    def forward(
        self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        b, s, _ = x.shape
        q = self.q_proj(x)
        hd = q.shape[-1] // self.n_heads  # robust to decomposed projections
        q = _rope(q.reshape(b, s, self.n_heads, hd), self.rope_theta)
        k = _rope(self.k_proj(x).reshape(b, s, self.n_kv_heads, hd), self.rope_theta)
        v = self.v_proj(x).reshape(b, s, self.n_kv_heads, hd)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (b, heads, s, hd)
        scale = hd ** -0.5
        # the model-level gate of transformer.py:4086-4117: bf16 on the card
        # with no padding mask and a head_dim the kernel is built for takes
        # the flash kernel (which reads the grouped k/v heads itself);
        # everything else takes the einsum path
        if (
            q.is_cuda
            and q.dtype == torch.bfloat16
            and attn_mask is None
            and hd in KERNEL_HEAD_DIMS
        ):
            out = flash_attention(q, k, v, scale)
        else:
            out = causal_attention_plain(q, k, v, scale, attn_mask)
        return self.o_proj(out.transpose(1, 2).reshape(b, s, -1))


class MLP(torch.nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, cfg: TransformerConfig, device: Any) -> None:
        super().__init__()
        kw = {"dtype": cfg.dtype, "device": device}
        self.gate_proj = torch.nn.Linear(cfg.dim, cfg.hidden_dim, bias=False, **kw)
        self.up_proj = torch.nn.Linear(cfg.dim, cfg.hidden_dim, bias=False, **kw)
        self.down_proj = torch.nn.Linear(cfg.hidden_dim, cfg.dim, bias=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Block(torch.nn.Module):
    def __init__(self, cfg: TransformerConfig, device: Any) -> None:
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype, device)
        self.self_attn = Attention(cfg, device)
        self.post_attention_layernorm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype, device)
        self.mlp = MLP(cfg, device)

    def forward(
        self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        h = x + self.self_attn(self.input_layernorm(x), attn_mask)
        return h + self.mlp(self.post_attention_layernorm(h))


class Decoder(torch.nn.Module):
    def __init__(self, cfg: TransformerConfig, device: Any) -> None:
        super().__init__()
        self.embed_tokens = torch.nn.Embedding(
            cfg.vocab_size, cfg.dim, dtype=cfg.dtype, device=device
        )
        self.layers = torch.nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_layers))
        self.norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype, device)

    def forward(
        self, input_ids: torch.Tensor, attn_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x, attn_mask)
        return self.norm(x)


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
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self._init_weights(generator)

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, torch.nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                m.weight.uniform_(-bound, bound, generator=gen)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=gen)
            elif isinstance(m, torch.nn.Embedding):
                m.weight.normal_(0.0, 0.02, generator=gen)

    def forward(self, batch: Any) -> torch.Tensor:
        if isinstance(batch, dict):
            input_ids, attn_mask = batch["input_ids"], batch.get("attention_mask")
        else:
            input_ids, attn_mask = batch, None
        h = self.model(input_ids, attn_mask)
        if self.lm_head is None:
            return h @ self.model.embed_tokens.weight.t()
        return self.lm_head(h)


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
