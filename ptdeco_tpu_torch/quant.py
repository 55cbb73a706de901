"""Weight-only int8 serving quantization, the Linear subset.

Counterpart of ``ptdeco_tpu/quant.py``: ``nn.Linear`` weights stored as
int8 with a per-output-channel f32 scale, converted with
``quantize_for_serving`` after decomposition and back with
``dequantize_for_serving``.  Decode is bound by reading weights, so int8
halves the bytes a step reads against bf16.  ``QuantLinear``'s own forward
dequantizes into the activation dtype and calls ``torch.matmul``; the MoE
layer's expert projections take the grouped int8 kernel instead
(``models.transformer.MoEMLP._grouped_int8``).  The int8 grid is held in
torch's (out, in) layout, the transpose of the JAX package's (in, out).
``QuantConv2d`` and the stacked-MoE forms are not ported.
"""

from __future__ import annotations

import logging
from typing import Collection, Optional

import torch

logger = logging.getLogger(__name__)

__all__ = [
    "QuantLinear",
    "quantize_linear",
    "dequantize_linear",
    "quantize_for_serving",
    "dequantize_for_serving",
]


class QuantLinear(torch.nn.Module):
    """``nn.Linear`` with its weight on a symmetric int8 grid:
    ``weight ≈ weight_q * scale[:, None]``."""

    def __init__(
        self,
        weight_q: torch.Tensor,
        scale: torch.Tensor,
        bias: Optional[torch.nn.Parameter] = None,
    ) -> None:
        super().__init__()
        self.register_buffer("weight_q", weight_q)  # (out, in) int8
        self.register_buffer("scale", scale)  # (out,) f32
        self.bias = bias

    @property
    def in_features(self) -> int:
        return self.weight_q.shape[1]

    @property
    def out_features(self) -> int:
        return self.weight_q.shape[0]

    def dequantized(self, dtype: torch.dtype) -> torch.Tensor:
        """The weight in ``dtype``: the grid and the scale are each cast to
        ``dtype`` and multiplied there, as the JAX forward does."""
        return self.weight_q.to(dtype) * self.scale.to(dtype)[:, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.dequantized(x.dtype).t())
        if self.bias is not None:
            y = y + self.bias
        return y


def quantize_linear(lin: torch.nn.Linear) -> QuantLinear:
    """Symmetric per-output-channel absmax quantization: scale = absmax / 127
    (1 for an all-zero channel), grid = round-half-to-even(w / scale)."""
    w = lin.weight.detach().to(torch.float32)
    absmax = torch.amax(torch.abs(w), dim=1)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    w_q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return QuantLinear(w_q, scale, lin.bias)


def dequantize_linear(q: QuantLinear, dtype: torch.dtype = torch.float32) -> torch.nn.Linear:
    """A plain ``nn.Linear`` holding ``weight_q * scale`` (in f32) in ``dtype``."""
    weight = (q.weight_q.to(torch.float32) * q.scale[:, None]).to(dtype)
    lin = torch.nn.Linear(
        q.in_features, q.out_features, bias=q.bias is not None, device="meta"
    )
    lin.weight = torch.nn.Parameter(weight)
    if q.bias is not None:
        lin.bias = q.bias
    return lin


def _router_gate_names(root: torch.nn.Module) -> set:
    """Dotted paths of MoE router gates and shared-expert gates: small,
    routing-critical matmuls that stay in full precision."""
    from .models.transformer import MoEMLP

    out = set()
    for name, m in root.named_modules():
        if type(m) is MoEMLP:
            prefix = f"{name}." if name else ""
            out.add(prefix + "gate")
            if m.shared_expert_gate is not None:
                out.add(prefix + "shared_expert_gate")
    return out


def quantize_for_serving(
    root: torch.nn.Module, *, skip_names: Collection[str] = (), min_features: int = 1
) -> torch.nn.Module:
    """Replace every exact-type ``nn.Linear`` under ``root`` with its
    ``QuantLinear`` (in place; returns ``root``).  MoE router and
    shared-expert gates, ``skip_names`` and Linears with fewer than
    ``min_features`` inputs or outputs (too small to be bound by reading
    their weights) are skipped."""
    from .nn import replace_submodule

    skip = set(skip_names) | _router_gate_names(root)
    n = 0
    for name, m in list(root.named_modules()):
        if name in skip or type(m) is not torch.nn.Linear:
            continue
        if min(m.in_features, m.out_features) < min_features:
            continue
        q = quantize_linear(m)
        if not name:
            return q
        replace_submodule(root, name, q)
        n += 1
    logger.info("quantized %d Linear sites to int8", n)
    return root


def dequantize_for_serving(
    root: torch.nn.Module, dtype: torch.dtype = torch.float32
) -> torch.nn.Module:
    """Restore every ``QuantLinear`` to a plain ``nn.Linear`` in ``dtype``
    (in place; returns ``root``)."""
    from .nn import replace_submodule

    for name, m in list(root.named_modules()):
        if type(m) is QuantLinear:
            lin = dequantize_linear(m, dtype)
            if not name:
                return lin
            replace_submodule(root, name, lin)
    return root
