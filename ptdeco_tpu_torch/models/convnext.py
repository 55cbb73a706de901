"""ConvNeXt family (ConvNeXt-Tiny / -Small and ConvNeXt-V2-Tiny) as plain
``torch.nn`` modules.

Counterpart of ``ptdeco_tpu/models/convnext.py`` (Liu et al. 2022):
a patchify stem, stages of blocks (7x7 depthwise conv -> LayerNorm -> 1x1
expand -> GELU -> 1x1 project, layer scale ``gamma``, residual) with a
LayerNorm and a 2x2 stride-2 conv between stages.  The block works as
timm's does: the depthwise conv on NCHW, then a permute to NHWC, where
the LayerNorm and the two pointwise layers (``pwconv1`` / ``pwconv2``, as
``nn.Linear`` on pixel rows) run; those two are the block's decomposition
sites.  ConvNeXt-V2 replaces the layer scale with Global Response
Normalization (``grn_gamma`` / ``grn_beta``, HF ConvNextV2GRN).

Module names are the JAX package's ``utils.state_dict`` export's
(``stages.S.B.pwconv1``, ``downsamples.S-1.conv``, ``head``), so its
weights load with ``utils.load_numpy_state_dict``.  NCHW at the
interface; on the card run it ``channels_last``, which makes the permute
to NHWC a view.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

__all__ = ["ConvNeXt", "ConvNeXtBlock", "convnext_tiny", "convnext_small", "convnextv2_tiny"]


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class ConvNeXtBlock(torch.nn.Module):
    def __init__(self, dim: int, ls_init: float = 1e-6, use_grn: bool = False, **kw) -> None:
        super().__init__()
        self.dwconv = torch.nn.Conv2d(dim, dim, 7, padding=3, groups=dim, **kw)
        self.norm = torch.nn.LayerNorm(dim, eps=1e-6, **kw)
        self.pwconv1 = torch.nn.Linear(dim, 4 * dim, **kw)
        self.pwconv2 = torch.nn.Linear(4 * dim, dim, **kw)
        if use_grn:
            self.register_parameter("gamma", None)
            self.grn_gamma = torch.nn.Parameter(torch.zeros(4 * dim, **kw))
            self.grn_beta = torch.nn.Parameter(torch.zeros(4 * dim, **kw))
        else:
            self.gamma = torch.nn.Parameter(torch.full((dim,), ls_init, **kw))
            self.register_parameter("grn_gamma", None)
            self.register_parameter("grn_beta", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _nhwc(self.dwconv(x))
        h = F.gelu(self.pwconv1(self.norm(h)))
        if self.grn_gamma is not None:
            # per-channel L2 over (H, W), divided by its mean over channels
            g = torch.sqrt(torch.sum(torch.square(h), dim=(1, 2), keepdim=True))
            n = g / (torch.mean(g, dim=-1, keepdim=True) + 1e-6)
            h = self.grn_gamma * (h * n) + self.grn_beta + h
        h = self.pwconv2(h)
        if self.gamma is not None:
            h = h * self.gamma
        return x + _nchw(h)


class LayerNorm2d(torch.nn.LayerNorm):
    """LayerNorm over the channels of an NCHW tensor (through NHWC)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nchw(super().forward(_nhwc(x)))


class Downsample(torch.nn.Module):
    def __init__(self, cin: int, cout: int, **kw) -> None:
        super().__init__()
        self.norm = LayerNorm2d(cin, eps=1e-6, **kw)
        self.conv = torch.nn.Conv2d(cin, cout, 2, stride=2, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(self.norm(x))


class ConvNeXt(torch.nn.Module):
    """Weights are drawn U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from
    ``generator`` (a fresh one seeded 0 when None), the JAX package's
    init; LayerNorms start at scale 1 and offset 0."""

    def __init__(
        self,
        depths: tuple[int, ...] = (3, 3, 9, 3),
        dims: tuple[int, ...] = (96, 192, 384, 768),
        num_classes: int = 1000,
        use_grn: bool = False,
        dtype: torch.dtype = torch.float32,
        device: Any = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        kw = {"dtype": dtype, "device": device}
        self.stem = torch.nn.Conv2d(3, dims[0], 4, stride=4, **kw)
        self.stem_norm = LayerNorm2d(dims[0], eps=1e-6, **kw)
        self.stages = torch.nn.ModuleList(
            torch.nn.Sequential(*(ConvNeXtBlock(dim, use_grn=use_grn, **kw) for _ in range(depth)))
            for depth, dim in zip(depths, dims))
        self.downsamples = torch.nn.ModuleList(
            Downsample(dims[i - 1], dims[i], **kw) for i in range(1, len(dims)))
        self.norm = torch.nn.LayerNorm(dims[-1], eps=1e-6, **kw)
        self.head = torch.nn.Linear(dims[-1], num_classes, **kw)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        init_uniform(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem_norm(self.stem(x))
        for i, stage in enumerate(self.stages):
            if i > 0:
                x = self.downsamples[i - 1](x)
            x = stage(x)
        return self.head(self.norm(x.mean(dim=(2, 3))))


@torch.no_grad()
def init_uniform(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Every Linear's and Conv2d's weight and bias U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), torch's default layer init and the JAX package's."""
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=gen)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=gen)


def convnext_tiny(num_classes: int = 1000, **kw) -> ConvNeXt:
    return ConvNeXt((3, 3, 9, 3), (96, 192, 384, 768), num_classes, **kw)


def convnext_small(num_classes: int = 1000, **kw) -> ConvNeXt:
    return ConvNeXt((3, 3, 27, 3), (96, 192, 384, 768), num_classes, **kw)


def convnextv2_tiny(num_classes: int = 1000, **kw) -> ConvNeXt:
    return ConvNeXt((3, 3, 9, 3), (96, 192, 384, 768), num_classes, use_grn=True, **kw)
