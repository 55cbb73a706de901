"""Phi-2 family causal LM (parallel attention and MLP blocks) in PyTorch.

Counterpart of ``ptdeco_tpu/models/phi.py``.  A biased LayerNorm feeds
attention and the MLP in parallel residual branches, rotary embeddings
cover the first ``rotary_dim`` dims of each head only (32 of 80 at
phi-2), every projection and the ``lm_head`` carry a bias, and the MLP is
tanh-GELU.  Attention is the plain causal softmax with f32 logits, as in
the JAX model: the JAX phi model never reaches the flash kernel, so this
one does not either.

Parameter names follow HF phi (``model.layers.N.self_attn.dense``,
``mlp.fc1`` / ``mlp.fc2``, ``model.final_layernorm``), so decompose
configs, state dicts and HF checkpoints line up with the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..ops.flash_attention import causal_attention_plain
from .transformer import LayerNorm, _checkpointed, _positions, _rope, init_weights

__all__ = ["PhiConfig", "PhiCausalLM"]


@dataclasses.dataclass(frozen=True)
class PhiConfig:
    vocab_size: int = 51200
    dim: int = 2560
    n_layers: int = 32
    n_heads: int = 32
    hidden_dim: int = 10240
    rope_theta: float = 10000.0
    partial_rotary_factor: float = 0.4
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32
    # per-block gradient checkpointing, as TransformerConfig.remat
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.partial_rotary_factor)

    @staticmethod
    def phi2(dtype: torch.dtype = torch.bfloat16) -> "PhiConfig":
        return PhiConfig(dtype=dtype)

    @staticmethod
    def from_hf_config(
        hf: dict[str, Any], dtype: torch.dtype = torch.bfloat16, remat: bool = False
    ) -> "PhiConfig":
        """HF ``config.json`` of model_type "phi" (phi-1, -1.5, -2) ->
        config, as the JAX package's ``PhiConfig.from_hf_config``."""
        if hf.get("model_type") != "phi":
            raise ValueError(f"not a phi config: {hf.get('model_type')!r}")
        if hf.get("hidden_act", "gelu_new") not in ("gelu_new", "gelu"):
            raise ValueError(f"Unsupported hidden_act={hf.get('hidden_act')!r}")
        n_heads = int(hf["num_attention_heads"])
        if int(hf.get("num_key_value_heads", n_heads)) != n_heads:
            raise ValueError("phi decoder here is MHA; GQA phi unsupported")
        return PhiConfig(
            vocab_size=int(hf["vocab_size"]),
            dim=int(hf["hidden_size"]),
            n_layers=int(hf["num_hidden_layers"]),
            n_heads=n_heads,
            hidden_dim=int(hf["intermediate_size"]),
            rope_theta=float(hf.get("rope_theta", 10000.0)),
            partial_rotary_factor=float(hf.get("partial_rotary_factor", 0.5)),
            norm_eps=float(hf.get("layer_norm_eps", 1e-5)),
            dtype=dtype,
            remat=remat,
        )

    @staticmethod
    def tiny(vocab_size: int = 256, dtype: torch.dtype = torch.float32) -> "PhiConfig":
        return PhiConfig(vocab_size=vocab_size, dim=64, n_layers=2, n_heads=4,
                         hidden_dim=128, dtype=dtype)


class PhiAttention(torch.nn.Module):
    def __init__(self, cfg: PhiConfig, device: Any) -> None:
        super().__init__()
        kw = {"bias": True, "dtype": cfg.dtype, "device": device}
        self.q_proj = torch.nn.Linear(cfg.dim, cfg.dim, **kw)
        self.k_proj = torch.nn.Linear(cfg.dim, cfg.dim, **kw)
        self.v_proj = torch.nn.Linear(cfg.dim, cfg.dim, **kw)
        self.dense = torch.nn.Linear(cfg.dim, cfg.dim, **kw)
        self.n_heads = cfg.n_heads
        self.rotary_dim = cfg.rotary_dim
        self.rope_theta = cfg.rope_theta

    def _partial_rope(self, t: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        return _rope(t, positions, self.rope_theta, partial_dim=self.rotary_dim)

    def forward(
        self,
        x: torch.Tensor,
        attn_mask: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        b, s, _ = x.shape
        q = self.q_proj(x)
        hd = q.shape[-1] // self.n_heads  # robust to decomposed projections
        q = q.reshape(b, s, self.n_heads, hd)
        k = self.k_proj(x).reshape(b, s, self.n_heads, hd)
        v = self.v_proj(x).reshape(b, s, self.n_heads, hd)
        if positions is None:
            positions = _positions(b, s, 0, x.device)
        q, k = self._partial_rope(q, positions), self._partial_rope(k, positions)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (b, heads, s, hd)
        out = causal_attention_plain(q, k, v, hd ** -0.5, attn_mask)
        return self.dense(out.transpose(1, 2).reshape(b, s, -1))


class PhiMLP(torch.nn.Module):
    def __init__(self, cfg: PhiConfig, device: Any) -> None:
        super().__init__()
        kw = {"bias": True, "dtype": cfg.dtype, "device": device}
        self.fc1 = torch.nn.Linear(cfg.dim, cfg.hidden_dim, **kw)
        self.fc2 = torch.nn.Linear(cfg.hidden_dim, cfg.dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class PhiBlock(torch.nn.Module):
    """Parallel residual: x + attn(ln(x)) + mlp(ln(x))."""

    def __init__(self, cfg: PhiConfig, device: Any) -> None:
        super().__init__()
        self.input_layernorm = LayerNorm(cfg.dim, cfg.norm_eps, cfg.dtype, device)
        self.self_attn = PhiAttention(cfg, device)
        self.mlp = PhiMLP(cfg, device)

    def forward(
        self,
        x: torch.Tensor,
        attn_mask: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        h = self.input_layernorm(x)
        return x + self.self_attn(h, attn_mask, positions) + self.mlp(h)


class PhiDecoder(torch.nn.Module):
    def __init__(self, cfg: PhiConfig, device: Any) -> None:
        super().__init__()
        self.embed_tokens = torch.nn.Embedding(
            cfg.vocab_size, cfg.dim, dtype=cfg.dtype, device=device
        )
        self.layers = torch.nn.ModuleList(PhiBlock(cfg, device) for _ in range(cfg.n_layers))
        self.final_layernorm = LayerNorm(cfg.dim, cfg.norm_eps, cfg.dtype, device)
        self.remat = cfg.remat

    def forward(
        self, input_ids: torch.Tensor, attn_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                x = _checkpointed(layer, x, attn_mask)
            else:
                x = layer(x, attn_mask)
        return self.final_layernorm(x)


class PhiCausalLM(torch.nn.Module):
    """Callable with a batch dict {"input_ids", optional "attention_mask"}
    (or a bare id tensor), returning logits from a biased ``lm_head``.
    Weights are drawn from ``generator`` (a fresh one seeded 0 when None)
    with the JAX package's initial distributions."""

    def __init__(
        self,
        cfg: PhiConfig,
        device: Any = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.model = PhiDecoder(cfg, device)
        self.lm_head = torch.nn.Linear(
            cfg.dim, cfg.vocab_size, bias=True, dtype=cfg.dtype, device=device
        )
        init_weights(self, generator, device)

    def forward(self, batch: Any) -> torch.Tensor:
        if isinstance(batch, dict):
            input_ids, attn_mask = batch["input_ids"], batch.get("attention_mask")
        else:
            input_ids, attn_mask = batch, None
        return self.lm_head(self.model(input_ids, attn_mask))
