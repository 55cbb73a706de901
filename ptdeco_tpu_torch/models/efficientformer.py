"""EfficientFormerV2 (S0 / S1) as plain ``torch.nn`` modules.

Counterpart of ``ptdeco_tpu/models/efficientformer.py``'s V2 family, a
hybrid of convolutions and attention: a stem of two 3x3 stride-2
conv + BatchNorm + GELU, four stages of conv-FFN blocks (1x1 expand ->
depthwise 3x3 -> 1x1 project, each conv + BatchNorm, with a per-channel
layer scale), whose last ``num_vit`` blocks of the last stage first run
an ``Attention4D`` token mixer (q / k / v 1x1 convs, attention over the
static grid with a learned per-head bias table, talking-head 1x1 convs
across the heads before and after an f32 softmax, a depthwise "local v"
branch, a 1x1 projection), conv + BatchNorm stride-2 downsamples between
stages, and a BatchNorm, mean pool and two classifier heads averaged.

Module names are the JAX package's ``utils.state_dict`` export's
(``stages.S.blocks.B.mlp.fc1.conv``, ``token_mixer.talking_head1``,
``head_dist``; ``bias_idx`` is a buffer), so its weights load with
``utils.load_numpy_state_dict``.  NCHW: the attention's (b, heads, q, k)
logits are an NCHW image whose channels are the heads, so the talking
heads are plain 1x1 convs.  The decomposition sites are every pointwise
conv (the FFNs' fc1 / fc2, q / k / v / proj, the talking heads) and the
two heads; the depthwise convs are not.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .convnext import init_uniform

__all__ = ["EfficientFormerV2", "Attention4D", "efficientformerv2_s0", "efficientformerv2_s1"]


class ConvNorm(torch.nn.Module):
    """A bias-free conv and its BatchNorm ('conv' / 'bn')."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
                 groups: int = 1, **kw) -> None:
        super().__init__()
        self.conv = torch.nn.Conv2d(cin, cout, k, stride=stride, padding=padding, groups=groups,
                                    bias=False, **kw)
        self.bn = torch.nn.BatchNorm2d(cout, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class ConvMlp(torch.nn.Module):
    """1x1 expand -> depthwise 3x3 -> 1x1 project, GELU between."""

    def __init__(self, dim: int, hidden: int, **kw) -> None:
        super().__init__()
        self.fc1 = ConvNorm(dim, hidden, 1, **kw)
        self.mid = ConvNorm(hidden, hidden, 3, padding=1, groups=hidden, **kw)
        self.fc2 = ConvNorm(hidden, dim, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.mid(F.gelu(self.fc1(x)))))


def attention_bias_index(res: int) -> np.ndarray:
    """(N, N) int32 ids of |offset| over a res x res grid (LeViT)."""
    pts = np.stack(np.meshgrid(np.arange(res), np.arange(res), indexing="ij"), -1).reshape(-1, 2)
    off = np.abs(pts[:, None, :] - pts[None, :, :])
    return (off[..., 0] * res + off[..., 1]).astype(np.int32)


class Attention4D(torch.nn.Module):
    def __init__(self, dim: int, res: int, n_heads: int = 8, key_dim: int = 32,
                 attn_ratio: int = 4, **kw) -> None:
        super().__init__()
        d = int(attn_ratio * key_dim)
        dh = d * n_heads
        self.n_heads, self.key_dim = n_heads, key_dim
        self.q = ConvNorm(dim, n_heads * key_dim, 1, **kw)
        self.k = ConvNorm(dim, n_heads * key_dim, 1, **kw)
        self.v = ConvNorm(dim, dh, 1, **kw)
        self.v_local = ConvNorm(dh, dh, 3, padding=1, groups=dh, **kw)
        self.talking_head1 = torch.nn.Conv2d(n_heads, n_heads, 1, **kw)
        self.talking_head2 = torch.nn.Conv2d(n_heads, n_heads, 1, **kw)
        self.proj = ConvNorm(dh, dim, 1, **kw)
        self.attention_biases = torch.nn.Parameter(torch.zeros(n_heads, res * res, **kw))
        self.register_buffer("bias_idx",
                             torch.from_numpy(attention_bias_index(res)).to(kw["device"]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        n, nh, kd = h * w, self.n_heads, self.key_dim
        q = self.q(x).reshape(b, nh, kd, n).transpose(-1, -2)
        k = self.k(x).reshape(b, nh, kd, n)
        vs = self.v(x)  # (b, nh * d, h, w), for the local branch
        v = vs.reshape(b, nh, -1, n).transpose(-1, -2)
        attn = (q.float() @ k.float()) * kd ** -0.5
        attn = attn + self.attention_biases.float()[:, self.bias_idx.long()][None]
        # the talking heads run in the compute dtype, the softmax in f32
        attn = self.talking_head1(attn.to(x.dtype))
        attn = torch.softmax(attn.float(), dim=-1)
        attn = self.talking_head2(attn.to(x.dtype)).to(x.dtype)
        # (b, heads, n, d) -> NHWC -> an NCHW view, channels_last as v_local's
        # output is on the card (the fused proj pair then reads it as rows)
        out = (attn @ v).permute(0, 2, 1, 3).reshape(b, h, w, -1).permute(0, 3, 1, 2)
        out = out + self.v_local(vs)
        return self.proj(F.gelu(out))


def _scaled(ls: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return ls[:, None, None] * x


class EFBlock(torch.nn.Module):
    def __init__(self, dim: int, ratio: float, ls_init: float = 1e-5, **kw) -> None:
        super().__init__()
        self.mlp = ConvMlp(dim, int(dim * ratio), **kw)
        self.ls2 = torch.nn.Parameter(torch.full((dim,), ls_init, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + _scaled(self.ls2, self.mlp(x))


class EFAttnBlock(torch.nn.Module):
    def __init__(self, dim: int, ratio: float, res: int, ls_init: float = 1e-5, **kw) -> None:
        super().__init__()
        self.token_mixer = Attention4D(dim, res, **kw)
        self.mlp = ConvMlp(dim, int(dim * ratio), **kw)
        self.ls1 = torch.nn.Parameter(torch.full((dim,), ls_init, **kw))
        self.ls2 = torch.nn.Parameter(torch.full((dim,), ls_init, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + _scaled(self.ls1, self.token_mixer(x))
        return x + _scaled(self.ls2, self.mlp(x))


class EFStage(torch.nn.Module):
    def __init__(self, downsample: Optional[ConvNorm], blocks: list[torch.nn.Module]) -> None:
        super().__init__()
        self.downsample = downsample
        self.blocks = torch.nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample is not None:
            x = self.downsample(x)
        return self.blocks(x)


class EfficientFormerV2(torch.nn.Module):
    """Conv and Linear weights are drawn U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    from ``generator`` (a fresh one seeded 0 when None); BatchNorms start
    at 1 / 0 with running statistics 0 / 1, layer scales at 1e-5 and the
    attention biases at 0, the JAX package's init."""

    def __init__(
        self,
        image_size: int = 224,
        dims: tuple[int, ...] = (32, 48, 96, 176),
        depths: tuple[int, ...] = (2, 2, 6, 4),
        ratios: tuple[tuple[float, ...], ...] = ((4, 4), (4, 4), (4, 3, 3, 3, 4, 4), (4, 3, 3, 4)),
        num_vit: int = 2,
        num_classes: int = 1000,
        dtype: torch.dtype = torch.float32,
        device: Any = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if image_size % 32:
            raise ValueError(f"image_size {image_size} must be divisible by 32")
        kw = {"dtype": dtype, "device": device}
        self.stem0 = ConvNorm(3, dims[0] // 2, 3, stride=2, padding=1, **kw)
        self.stem1 = ConvNorm(dims[0] // 2, dims[0], 3, stride=2, padding=1, **kw)
        res = image_size // 4
        stages = []
        for s, depth in enumerate(depths):
            down = None
            if s > 0:
                down = ConvNorm(dims[s - 1], dims[s], 3, stride=2, padding=1, **kw)
                res //= 2
            blocks: list[torch.nn.Module] = []
            for b in range(depth):
                ratio = ratios[s][b] if b < len(ratios[s]) else 4
                if s == len(depths) - 1 and b >= depth - num_vit:
                    blocks.append(EFAttnBlock(dims[s], ratio, res, **kw))
                else:
                    blocks.append(EFBlock(dims[s], ratio, **kw))
            stages.append(EFStage(down, blocks))
        self.stages = torch.nn.Sequential(*stages)
        self.norm = torch.nn.BatchNorm2d(dims[-1], **kw)
        self.head = torch.nn.Linear(dims[-1], num_classes, **kw)
        self.head_dist = torch.nn.Linear(dims[-1], num_classes, **kw)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        init_uniform(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self.stem0(x))
        x = F.gelu(self.stem1(x))
        x = self.norm(self.stages(x)).mean(dim=(2, 3))
        return (self.head(x) + self.head_dist(x)) / 2.0


def efficientformerv2_s0(num_classes: int = 1000, image_size: int = 224, **kw) -> EfficientFormerV2:
    return EfficientFormerV2(image_size, (32, 48, 96, 176), (2, 2, 6, 4),
                             ((4, 4), (4, 4), (4, 3, 3, 3, 4, 4), (4, 3, 3, 4)), 2, num_classes,
                             **kw)


def efficientformerv2_s1(num_classes: int = 1000, image_size: int = 224, **kw) -> EfficientFormerV2:
    return EfficientFormerV2(image_size, (32, 48, 120, 224), (3, 3, 9, 6),
                             ((4, 4, 4), (4, 4, 4), (4, 4, 3, 3, 3, 3, 4, 4, 4),
                              (4, 4, 3, 3, 4, 4)), 2, num_classes, **kw)
