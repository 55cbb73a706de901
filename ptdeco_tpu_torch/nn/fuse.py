"""Serving-path fusion of decomposed Linear factor pairs.

``fuse_factor_pairs`` swaps every ``Sequential(Linear(bias=False), Linear)``
factor pair (the artifact of decomposition) for a ``FusedLowRankLinear``
whose forward is the fused low-rank kernel (``ops/lowrank.py``): the rank-r
hidden never goes to device memory.  A pair the kernel does not take
(``ops.lowrank.kernel_takes``: a dtype other than bf16 or f32, or a rank
whose hidden does not fit in shared memory) stays unfused, as the Pallas
entry point computes such a pair unfused.  ``unfuse_factor_pairs``
restores the checkpoint-compatible pairs (state-dict naming is defined on
the pair, so fuse before serving, unfuse before saving).  Conv pairs are
not fused in this package yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import replace_submodule

__all__ = ["FusedLowRankLinear", "fuse_factor_pairs", "unfuse_factor_pairs"]


class FusedLowRankLinear(torch.nn.Module):
    """y = (x @ weight1ᵀ) @ weight2ᵀ + bias, the pair's own parameters."""

    def __init__(
        self,
        weight1: torch.nn.Parameter,
        weight2: torch.nn.Parameter,
        bias: Optional[torch.nn.Parameter],
    ) -> None:
        super().__init__()
        self.weight1 = weight1  # (r, in), the first factor's weight
        self.weight2 = weight2  # (out, r), the second factor's weight
        self.bias = bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops.lowrank import lowrank_matmul

        return lowrank_matmul(x, self.weight1.t(), self.weight2.t(), self.bias)


def _is_fusable_pair(m: torch.nn.Module) -> bool:
    from ..ops.lowrank import kernel_takes

    if not (
        isinstance(m, torch.nn.Sequential)
        and len(m) == 2
        and type(m[0]) is torch.nn.Linear
        and type(m[1]) is torch.nn.Linear
        and m[0].bias is None
    ):
        return False
    dtype = m[0].weight.dtype
    return all(p.dtype == dtype for p in m[1].parameters()) and kernel_takes(
        dtype, m[0].out_features
    )


def fuse_factor_pairs(root: torch.nn.Module) -> torch.nn.Module:
    """Replace decomposed factor pairs that the kernel takes with fused
    modules (in place)."""
    for name, m in list(root.named_modules()):
        if name and _is_fusable_pair(m):
            replace_submodule(root, name, FusedLowRankLinear(m[0].weight, m[1].weight, m[1].bias))
    return root


def unfuse_factor_pairs(root: torch.nn.Module) -> torch.nn.Module:
    """Restore the checkpoint-compatible Sequential factor pairs (in place)."""
    for name, m in list(root.named_modules()):
        if isinstance(m, FusedLowRankLinear):
            r, d_in = m.weight1.shape
            d_out = m.weight2.shape[0]
            kw = {"device": m.weight1.device, "dtype": m.weight1.dtype}
            first = torch.nn.Linear(d_in, r, bias=False, **kw)
            second = torch.nn.Linear(r, d_out, bias=m.bias is not None, **kw)
            first.weight = m.weight1
            second.weight = m.weight2
            if m.bias is not None:
                second.bias = m.bias
            replace_submodule(root, name, torch.nn.Sequential(first, second))
    return root
