"""Serving-path fusion of decomposed factor pairs.

``fuse_factor_pairs`` swaps every ``Sequential(Linear(bias=False), Linear)``
factor pair (the artifact of decomposition), and every pair of plain 1x1
convs (stride 1, unpadded, groups 1, a bias-free first factor), for a
``FusedLowRankLinear`` whose forward is the fused low-rank kernel
(``ops/lowrank.py``): the rank-r hidden never goes to device memory.  A
fused conv pair sends its NCHW input's pixels as rows ``(N*H*W, C)``, a
view when the activation is ``channels_last``; strided or padded pairs
stay unfused, as in the JAX package.  A pair the kernel does not take
(``ops.lowrank.kernel_takes``: a dtype other than bf16 or f32, or a rank
whose hidden does not fit in shared memory) stays unfused, as the Pallas
entry point computes such a pair unfused.  ``unfuse_factor_pairs``
restores the checkpoint-compatible pairs (state-dict naming is defined on
the pair, so fuse before serving, unfuse before saving), bit-equal: the
fused module holds the pair's own parameters.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import replace_submodule

__all__ = ["FusedLowRankLinear", "fuse_factor_pairs", "unfuse_factor_pairs"]


class FusedLowRankLinear(torch.nn.Module):
    """y = (x @ weight1ᵀ) @ weight2ᵀ + bias, the pair's own parameters; with
    ``from_conv`` the 1x1 conv pair's 4D weights, applied to every pixel of
    an NCHW input."""

    def __init__(
        self,
        weight1: torch.nn.Parameter,
        weight2: torch.nn.Parameter,
        bias: Optional[torch.nn.Parameter],
        from_conv: bool = False,
    ) -> None:
        super().__init__()
        self.weight1 = weight1  # (r, in) or (r, in, 1, 1), the first factor's weight
        self.weight2 = weight2  # (out, r) or (out, r, 1, 1), the second factor's weight
        self.bias = bias
        self.from_conv = from_conv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops.lowrank import lowrank_linear

        if not self.from_conv:
            return lowrank_linear(x, self.weight1, self.weight2, self.bias)
        w1 = self.weight1.reshape(self.weight1.shape[0], -1)
        w2 = self.weight2.reshape(self.weight2.shape[0], -1)
        # NCHW -> NHWC, a view of a channels_last activation; the output
        # keeps that layout
        return lowrank_linear(x.permute(0, 2, 3, 1), w1, w2, self.bias).permute(0, 3, 1, 2)


def _is_plain_conv1x1(m: torch.nn.Module) -> bool:
    return (type(m) is torch.nn.Conv2d and m.kernel_size == (1, 1) and m.groups == 1
            and m.stride == (1, 1) and m.padding in ((0, 0), 0) and m.dilation == (1, 1))


def _is_fusable_pair(m: torch.nn.Module) -> bool:
    from ..ops.lowrank import kernel_takes

    if not (isinstance(m, torch.nn.Sequential) and len(m) == 2
            and ((type(m[0]) is torch.nn.Linear and type(m[1]) is torch.nn.Linear)
                 or (_is_plain_conv1x1(m[0]) and _is_plain_conv1x1(m[1])))
            and m[0].bias is None):
        return False
    dtype = m[0].weight.dtype
    return all(p.dtype == dtype for p in m[1].parameters()) and kernel_takes(
        dtype, m[0].weight.shape[0]
    )


def fuse_factor_pairs(root: torch.nn.Module) -> torch.nn.Module:
    """Replace decomposed factor pairs that the kernel takes with fused
    modules (in place)."""
    for name, m in list(root.named_modules()):
        if name and _is_fusable_pair(m):
            replace_submodule(root, name, FusedLowRankLinear(
                m[0].weight, m[1].weight, m[1].bias, from_conv=isinstance(m[0], torch.nn.Conv2d)))
    return root


def unfuse_factor_pairs(root: torch.nn.Module) -> torch.nn.Module:
    """Restore the checkpoint-compatible Sequential factor pairs (in place)."""
    for name, m in list(root.named_modules()):
        if isinstance(m, FusedLowRankLinear):
            r, d_in = m.weight1.shape[:2]
            d_out = m.weight2.shape[0]
            kw = {"bias": m.bias is not None, "device": "meta"}
            if m.from_conv:
                first = torch.nn.Conv2d(d_in, r, 1, bias=False, device="meta")
                second = torch.nn.Conv2d(r, d_out, 1, **kw)
            else:
                first = torch.nn.Linear(d_in, r, bias=False, device="meta")
                second = torch.nn.Linear(r, d_out, **kw)
            first.weight = m.weight1
            second.weight = m.weight2
            if m.bias is not None:
                second.bias = m.bias
            replace_submodule(root, name, torch.nn.Sequential(first, second))
    return root
