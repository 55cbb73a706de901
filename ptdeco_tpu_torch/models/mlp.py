"""Small synthetic models for tests and benchmarks (counterpart of
``ptdeco_tpu/models/mlp.py``)."""

from __future__ import annotations

import math
from typing import Any, Optional

import torch

__all__ = ["MLP", "make_mlp"]


class MLP(torch.nn.Module):
    """Stack of Linear+relu blocks with a head; accepts a dict or a tensor."""

    def __init__(self, blocks: list[torch.nn.Linear], head: torch.nn.Linear) -> None:
        super().__init__()
        self.blocks = torch.nn.ModuleList(blocks)
        self.head = head

    def forward(self, batch: Any) -> torch.Tensor:
        x = batch["inp"] if isinstance(batch, dict) else batch
        for blk in self.blocks:
            x = torch.relu(blk(x))
        return self.head(x)


def make_mlp(
    dim: int = 1024,
    depth: int = 4,
    n_out: int = 16,
    dtype: torch.dtype = torch.float32,
    device: Any = "cuda",
    generator: Optional[torch.Generator] = None,
) -> MLP:
    """Linear layers drawn U(-1/sqrt(in), 1/sqrt(in)) from ``generator``
    (a fresh one seeded 0 when None), torch.nn.Linear's distribution."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def linear(d_in: int, d_out: int) -> torch.nn.Linear:
        m = torch.nn.Linear(d_in, d_out, dtype=dtype, device=device)
        bound = 1.0 / math.sqrt(d_in)
        with torch.no_grad():
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
        return m

    return MLP([linear(dim, dim) for _ in range(depth)], linear(dim, n_out))
