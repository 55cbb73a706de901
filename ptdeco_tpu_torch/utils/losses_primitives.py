"""Loss primitives (PyTorch).

Same numerics as ``ptdeco_tpu/utils/losses_primitives.py``: NSR uses the
unbiased (ddof=1) per-channel variance and epsilon 1e-3; the KL divergence
sums over axis 1; the KL loss is the mean of the elementwise max of both
directions.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = [
    "calc_per_channel_noise_to_signal_ratio",
    "calc_kl_divergence",
    "calc_kl_loss",
]


def calc_per_channel_noise_to_signal_ratio(
    x: torch.Tensor,
    y: torch.Tensor,
    non_channel_dim: Sequence[int] = (0, 2, 3),
    epsilon: float = 1e-3,
    mode: str = "mean",
) -> torch.Tensor:
    """mean over channels of mean((x-y)^2) / (var_unbiased(y) + eps)."""
    del mode  # only "mean" is implemented, as in the reference
    dims = tuple(non_channel_dim)
    x32 = x.to(torch.float32)
    y32 = y.to(torch.float32)
    y_per_channel_variance = torch.var(y32, dim=dims, correction=1)
    per_channel_squared_difference = torch.mean(torch.square(x32 - y32), dim=dims)
    return torch.mean(per_channel_squared_difference / (y_per_channel_variance + epsilon))


def calc_kl_divergence(q_logits: torch.Tensor, p_logits: torch.Tensor) -> torch.Tensor:
    q_prob = torch.softmax(q_logits.to(torch.float32), dim=-1)
    p_prob = torch.softmax(p_logits.to(torch.float32), dim=-1)
    return torch.sum(p_prob * torch.log(p_prob / q_prob), dim=1)


def calc_kl_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor) -> torch.Tensor:
    return torch.mean(
        torch.maximum(
            calc_kl_divergence(student_logits, teacher_logits),
            calc_kl_divergence(teacher_logits, student_logits),
        )
    )
