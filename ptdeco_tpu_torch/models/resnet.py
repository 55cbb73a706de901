"""ResNet family (18/34/50/101) as plain ``torch.nn`` modules.

Counterpart of ``ptdeco_tpu/models/resnet.py``: torchvision's topology and
module names (``layer1.0.conv1``, ``layer2.0.downsample.0``, ``fc``), so the
JAX package's ``utils.state_dict`` export loads here unchanged with
``utils.load_numpy_state_dict``.  NCHW at the interface; on the card run it
``channels_last`` (``model.to(memory_format=torch.channels_last)`` and the
same for the images), so that a 1x1 conv's pixels are rows of a matrix
without a copy.  Bottleneck blocks hold the 1x1 convs that dwain and falor
decompose; lockd wraps every conv and the fc.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch

__all__ = ["ResNet", "BasicBlock", "Bottleneck", "resnet18", "resnet34", "resnet50",
           "resnet101"]


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0, **kw) -> torch.nn.Conv2d:
    return torch.nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False, **kw)


def _downsample(cin: int, cout: int, stride: int, **kw) -> Optional[torch.nn.Sequential]:
    """1x1 strided conv + BN ('downsample.0' / 'downsample.1')."""
    if stride == 1 and cin == cout:
        return None
    return torch.nn.Sequential(_conv(cin, cout, 1, stride, **kw), torch.nn.BatchNorm2d(cout, **kw))


class BasicBlock(torch.nn.Module):
    def __init__(self, cin: int, width: int, cout: int, stride: int, **kw) -> None:
        super().__init__()
        self.conv1 = _conv(cin, cout, 3, stride, 1, **kw)
        self.bn1 = torch.nn.BatchNorm2d(cout, **kw)
        self.conv2 = _conv(cout, cout, 3, 1, 1, **kw)
        self.bn2 = torch.nn.BatchNorm2d(cout, **kw)
        self.downsample = _downsample(cin, cout, stride, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class Bottleneck(torch.nn.Module):
    """1x1 -> 3x3 (the stride, torchvision v1.5) -> 1x1."""

    def __init__(self, cin: int, width: int, cout: int, stride: int, **kw) -> None:
        super().__init__()
        self.conv1 = _conv(cin, width, 1, **kw)
        self.bn1 = torch.nn.BatchNorm2d(width, **kw)
        self.conv2 = _conv(width, width, 3, stride, 1, **kw)
        self.bn2 = torch.nn.BatchNorm2d(width, **kw)
        self.conv3 = _conv(width, cout, 1, **kw)
        self.bn3 = torch.nn.BatchNorm2d(cout, **kw)
        self.downsample = _downsample(cin, cout, stride, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class ResNet(torch.nn.Module):
    """``block`` "basic" or "bottleneck", ``layers`` blocks per stage.

    Weights are drawn U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from ``generator``
    (a fresh one seeded 0 when None), the JAX package's init; BatchNorm
    starts at scale 1, offset 0, running mean 0 and variance 1."""

    def __init__(
        self,
        block: str,
        layers: tuple[int, ...],
        num_classes: int = 1000,
        dtype: torch.dtype = torch.float32,
        device: Any = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        kw = {"dtype": dtype, "device": device}
        cls, expansion = {"basic": (BasicBlock, 1), "bottleneck": (Bottleneck, 4)}[block]
        self.conv1 = _conv(3, 64, 7, 2, 3, **kw)
        self.bn1 = torch.nn.BatchNorm2d(64, **kw)
        self.maxpool = torch.nn.MaxPool2d(3, 2, 1)
        cin = 64
        for stage, n_blocks in enumerate(layers):
            width = 64 * 2 ** stage
            blocks = []
            for b in range(n_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                blocks.append(cls(cin, width, width * expansion, stride, **kw))
                cin = width * expansion
            self.add_module(f"layer{stage + 1}", torch.nn.Sequential(*blocks))
        self.fc = torch.nn.Linear(cin, num_classes, **kw)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self._init_weights(generator)

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.uniform_(-bound, bound, generator=gen)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
        return self.fc(x.mean(dim=(2, 3)))


def resnet18(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet("basic", (2, 2, 2, 2), num_classes, **kw)


def resnet34(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet("basic", (3, 4, 6, 3), num_classes, **kw)


def resnet50(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet("bottleneck", (3, 4, 6, 3), num_classes, **kw)


def resnet101(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet("bottleneck", (3, 4, 23, 3), num_classes, **kw)
