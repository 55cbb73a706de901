"""LOCKD training losses (counterpart of ``ptdeco_tpu/lockd/losses.py``,
reference ``ptdeco/lockd/losses.py``).

The entropy and proportion losses read the gate logits of the wrapped
layers; the NSR losses read the sink a forward under a bound ``Ctx``
filled (``forward_collecting``), the port's form of the JAX package's
sown NSRs.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from . import decomposition
from .decomposition import Ctx, bind

__all__ = [
    "calc_entropy_from_logits",
    "get_entropy_dict",
    "get_entropy_loss",
    "get_nsr_dict",
    "get_nsr_loss",
    "get_proportion_dict",
    "get_proportion_loss",
    "forward_collecting",
]


def calc_entropy_from_logits(logits: torch.Tensor, epsilon: float = 0.01) -> torch.Tensor:
    """Mean binary entropy of sigmoid(logits), floored at ``epsilon``, in its
    softplus form ``log(1 + e^z) - z sigmoid(z)``: the p log p form is
    0 * log 0 = NaN once |z| saturates f32's sigmoid (the reference's
    formula, losses.py:16-23, has that latent NaN)."""
    z = logits.to(torch.float32)
    entropy = torch.nn.functional.softplus(z) - z * torch.sigmoid(z)
    return torch.clamp_min(torch.mean(entropy), epsilon)


def get_entropy_dict(wrapped_module: torch.nn.Module) -> dict[str, torch.Tensor]:
    return {name: calc_entropy_from_logits(m.logits)
            for name, m in decomposition.named_wrapped_modules(wrapped_module)}


def get_entropy_loss(wrapped_module: torch.nn.Module) -> torch.Tensor:
    return torch.stack(list(get_entropy_dict(wrapped_module).values())).mean()


def forward_collecting(root: torch.nn.Module, x: Any,
                       generators: Optional[dict[int, torch.Generator]] = None,
                       noise: Optional[dict[int, torch.Tensor]] = None,
                       ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Forward pass returning (output, {layer name: student NSR}); the gates
    sample from ``generators`` or ``noise`` when given, else take their
    expected value."""
    with bind(root, Ctx(generators, noise)) as ctx:
        y = root(x)
    return y, dict(ctx.sink)


def get_nsr_dict(nsr_sink: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return dict(nsr_sink)


def get_nsr_loss(nsr_sink: dict[str, torch.Tensor], nsr_threshold: float) -> torch.Tensor:
    """Mean over layers of relu(nsr - t) / t (reference losses.py:56-62)."""
    if not nsr_sink:
        raise ValueError(
            "empty NSR sink: no wrapped layers ran in this forward; wrap the model first "
            "(lockd.wrap) and check the blacklist did not exclude every Linear/Conv2d"
        )
    return torch.stack([torch.relu(v - nsr_threshold) / nsr_threshold
                        for v in nsr_sink.values()]).mean()


def get_proportion_dict(wrapped_module: torch.nn.Module) -> dict[str, torch.Tensor]:
    return {name: decomposition.calc_propotion_from_logits(m.logits)
            for name, m in decomposition.named_wrapped_modules(wrapped_module)}


def get_proportion_loss(wrapped_module: torch.nn.Module) -> torch.Tensor:
    return torch.stack(list(get_proportion_dict(wrapped_module).values())).mean()
