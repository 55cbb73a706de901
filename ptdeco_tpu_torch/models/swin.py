"""Swin Transformer V2 (and V1) as plain ``torch.nn`` modules.

Counterpart of ``ptdeco_tpu/models/swin.py``'s ``SwinV2`` with its ``v1``
flag (``swinv2_tiny`` / ``swinv2_small`` / ``swin_tiny``): 4 stages of
blocks over (B, N, C) tokens, window attention in w x w windows, shifted
by w // 2 on every other block (a roll and a static -100 mask), and a
2x2 patch merge (4C -> 2C) between stages.  V2's attention is the cosine
similarity of q and k times a learned per-head temperature (clamped at
ln 100), plus a continuous position bias: an MLP (``cpb_fc1`` 2 -> 512,
ReLU, ``cpb_fc2`` -> heads) of log-spaced relative coordinates, squashed
by 16 sigmoid; its blocks post-norm the residual branch
(x + norm(attn(x))) and its merge norms the 2C output.  V1 is scaled dot
product plus a learned relative-position bias table, pre-norm blocks, and
a merge that norms the 4C input.  Attention is the plain softmax with
f32 logits, as in the JAX model: a bias-carrying window attention is no
flash shape.

Module names are the JAX package's ``utils.state_dict`` export's
(``stages.S.blocks.B.attn.qkv``, ``stages.S.downsample.reduction``);
the relative-coordinate, index and shift-mask tables are buffers under
the JAX names (``rel_coords``, ``rel_index``, ``attn_mask``), so that
export loads with ``utils.load_numpy_state_dict`` unchanged.  The
decomposition sites are each block's qkv / proj / fc1 / fc2, each merge's
reduction, the head, and the 2-wide CPB Linears.  NCHW images at the
interface; the patch embedding's output becomes tokens by a view when it
is ``channels_last``.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .convnext import init_uniform

__all__ = ["SwinV2", "SwinBlock", "WindowAttention", "PatchMerging", "swinv2_tiny",
           "swinv2_small", "swin_tiny"]


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H/w * W/w, w*w, C)."""
    b, h, wd, c = x.shape
    x = x.reshape(b, h // w, w, wd // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, c)


def window_reverse(x: torch.Tensor, w: int, h: int, wd: int) -> torch.Tensor:
    """The inverse of ``window_partition``."""
    b = x.shape[0] // ((h // w) * (wd // w))
    x = x.reshape(b, h // w, wd // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, wd, -1)


def relative_coords_log(window: int) -> np.ndarray:
    """V2's CPB input: log-spaced relative coordinates, ((2w-1)², 2) f32."""
    coords = np.arange(-(window - 1), window, dtype=np.float32)
    grid = np.stack(np.meshgrid(coords, coords, indexing="ij"), axis=-1).reshape(-1, 2)
    grid = grid / (window - 1) * 8.0 if window > 1 else grid
    return np.sign(grid) * np.log2(np.abs(grid) + 1.0) / np.log2(8.0)


def relative_index(window: int) -> np.ndarray:
    """(w², w²) int32 indices into the (2w-1)² relative-coordinate table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"),
                      axis=0).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :] + (window - 1)
    return (rel[0] * (2 * window - 1) + rel[1]).astype(np.int32)


def shift_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """(nW, w², w²) f32: -100 where a shifted window mixes pixels of
    different pre-roll regions, else 0."""
    img = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = window_partition(torch.from_numpy(img), window).numpy().reshape(-1, window * window)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(torch.nn.Module):
    def __init__(self, dim: int, n_heads: int, window: int, cpb_hidden: int = 512,
                 v1: bool = False, **kw) -> None:
        super().__init__()
        device = kw["device"]
        self.n_heads = n_heads
        self.qkv = torch.nn.Linear(dim, 3 * dim, **kw)
        self.proj = torch.nn.Linear(dim, dim, **kw)
        if v1:
            self.rel_bias_table = torch.nn.Parameter(
                torch.zeros(((2 * window - 1) ** 2, n_heads), **kw))
            self.logit_scale = self.cpb_fc1 = self.cpb_fc2 = None
            self.register_buffer("rel_coords", None)
        else:
            self.register_parameter("rel_bias_table", None)
            self.logit_scale = torch.nn.Parameter(torch.full((n_heads, 1, 1), float(np.log(10.0)),
                                                             **kw))
            self.cpb_fc1 = torch.nn.Linear(2, cpb_hidden, **kw)
            self.cpb_fc2 = torch.nn.Linear(cpb_hidden, n_heads, bias=False, **kw)
            self.register_buffer("rel_coords", torch.from_numpy(relative_coords_log(window)).to(
                **kw))
        self.register_buffer("rel_index", torch.from_numpy(relative_index(window)).to(device))

    def position_bias(self) -> torch.Tensor:
        """(heads, w², w²) f32."""
        index = self.rel_index.long()
        if self.rel_bias_table is not None:
            bias = self.rel_bias_table[index].float()
        else:
            bias = self.cpb_fc2(F.relu(self.cpb_fc1(self.rel_coords)))
            bias = (16.0 * torch.sigmoid(bias.float()))[index]
        return bias.permute(2, 0, 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        bw, n, _ = x.shape
        qkv = self.qkv(x)
        inner = qkv.shape[-1] // 3
        hd = inner // self.n_heads
        q, k, v = (t.reshape(bw, n, self.n_heads, hd).transpose(1, 2)
                   for t in qkv.split(inner, dim=-1))
        if self.rel_bias_table is not None:
            attn = (q.float() @ k.float().transpose(-1, -2)) * hd ** -0.5
        else:
            q = F.normalize(q, dim=-1, eps=1e-6)
            k = F.normalize(k, dim=-1, eps=1e-6)
            scale = torch.exp(torch.clamp(self.logit_scale.float(), max=float(np.log(100.0))))
            attn = (q.float() @ k.float().transpose(-1, -2)) * scale
        attn = attn + self.position_bias()[None]
        if mask is not None:
            n_win = mask.shape[0]
            attn = attn.reshape(-1, n_win, self.n_heads, n, n) + mask.float()[None, :, None]
            attn = attn.reshape(bw, self.n_heads, n, n)
        probs = torch.softmax(attn, dim=-1).to(x.dtype)
        out = (probs @ v).transpose(1, 2).reshape(bw, n, inner)
        return self.proj(out)


class SwinMLP(torch.nn.Module):
    def __init__(self, dim: int, hidden: int, **kw) -> None:
        super().__init__()
        self.fc1 = torch.nn.Linear(dim, hidden, **kw)
        self.fc2 = torch.nn.Linear(hidden, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(torch.nn.Module):
    """V2 post-norms the residual branches (x + norm(f(x))); V1 pre-norms
    them (x + f(norm(x)))."""

    def __init__(self, dim: int, n_heads: int, resolution: tuple[int, int], window: int,
                 shift: int, mlp_ratio: float = 4.0, v1: bool = False, **kw) -> None:
        super().__init__()
        window = min(window, min(resolution))
        shift = 0 if window >= min(resolution) else shift
        if resolution[0] % window or resolution[1] % window:
            raise ValueError(f"window {window} must divide stage resolution {resolution} "
                             "(pick image_size/patch_size so every stage is divisible)")
        self.resolution, self.window, self.shift, self.pre_norm = tuple(resolution), window, shift, v1
        self.norm1 = torch.nn.LayerNorm(dim, eps=1e-5, **kw)
        self.attn = WindowAttention(dim, n_heads, window, v1=v1, **kw)
        self.norm2 = torch.nn.LayerNorm(dim, eps=1e-5, **kw)
        self.mlp = SwinMLP(dim, int(dim * mlp_ratio), **kw)
        mask = None
        if shift > 0:
            mask = torch.from_numpy(shift_attn_mask(*resolution, window, shift)).to(**kw)
        self.register_buffer("attn_mask", mask)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.resolution
        b, n, c = x.shape
        shortcut = x
        if self.pre_norm:
            x = self.norm1(x)
        x = x.reshape(b, h, w, c)
        if self.shift > 0:
            x = torch.roll(x, (-self.shift, -self.shift), dims=(1, 2))
        x = window_reverse(self.attn(window_partition(x, self.window), self.attn_mask),
                           self.window, h, w)
        if self.shift > 0:
            x = torch.roll(x, (self.shift, self.shift), dims=(1, 2))
        x = x.reshape(b, n, c)
        if self.pre_norm:
            x = shortcut + x
            return x + self.mlp(self.norm2(x))
        x = shortcut + self.norm1(x)
        return x + self.norm2(self.mlp(x))


class PatchMerging(torch.nn.Module):
    """2x2 neighbourhood concat (upstream order: column offset major) and a
    4C -> 2C reduction; V2 norms after it, V1 before."""

    def __init__(self, dim: int, resolution: tuple[int, int], v1: bool = False, **kw) -> None:
        super().__init__()
        self.resolution, self.norm_first = tuple(resolution), v1
        self.reduction = torch.nn.Linear(4 * dim, 2 * dim, bias=False, **kw)
        self.norm = torch.nn.LayerNorm(4 * dim if v1 else 2 * dim, eps=1e-5, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.resolution
        b, _, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 4, 2, 5)
        x = x.reshape(b, (h // 2) * (w // 2), 4 * c)
        if self.norm_first:
            return self.reduction(self.norm(x))
        return self.norm(self.reduction(x))


class SwinStage(torch.nn.Module):
    def __init__(self, blocks: list[SwinBlock], downsample: Optional[PatchMerging]) -> None:
        super().__init__()
        self.blocks = torch.nn.Sequential(*blocks)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.blocks(x)
        return x if self.downsample is None else self.downsample(x)


class SwinV2(torch.nn.Module):
    """Linear and conv weights are drawn U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    from ``generator`` (a fresh one seeded 0 when None); LayerNorms start
    at 1 / 0, the temperatures at ln 10 and V1's bias tables at 0, the
    JAX package's init."""

    def __init__(
        self,
        image_size: int = 224,
        patch_size: int = 4,
        embed_dim: int = 96,
        depths: tuple[int, ...] = (2, 2, 6, 2),
        n_heads: tuple[int, ...] = (3, 6, 12, 24),
        window: int = 7,
        num_classes: int = 1000,
        v1: bool = False,
        dtype: torch.dtype = torch.float32,
        device: Any = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        kw = {"dtype": dtype, "device": device}
        res = image_size // patch_size
        stages = []
        dim = embed_dim
        for s, depth in enumerate(depths):
            blocks = [SwinBlock(dim, n_heads[s], (res, res), window,
                                shift=0 if b % 2 == 0 else window // 2, v1=v1, **kw)
                      for b in range(depth)]
            down = None
            if s < len(depths) - 1:
                down = PatchMerging(dim, (res, res), v1=v1, **kw)
                dim *= 2
                res //= 2
            stages.append(SwinStage(blocks, down))
        self.patch_embed = torch.nn.Conv2d(3, embed_dim, patch_size, stride=patch_size, **kw)
        self.patch_norm = torch.nn.LayerNorm(embed_dim, eps=1e-5, **kw)
        self.stages = torch.nn.Sequential(*stages)
        self.norm = torch.nn.LayerNorm(dim, eps=1e-5, **kw)
        self.head = torch.nn.Linear(dim, num_classes, **kw)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        init_uniform(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_embed(x).permute(0, 2, 3, 1)  # (b, h/4, w/4, C)
        h = self.patch_norm(p.reshape(p.shape[0], -1, p.shape[-1]))
        h = self.norm(self.stages(h))
        return self.head(h.mean(dim=1))


def swinv2_tiny(num_classes: int = 1000, image_size: int = 224, **kw) -> SwinV2:
    """embed 96, depths (2, 2, 6, 2), heads (3, 6, 12, 24), window 7."""
    return SwinV2(image_size, 4, 96, (2, 2, 6, 2), (3, 6, 12, 24), 7, num_classes, **kw)


def swinv2_small(num_classes: int = 1000, image_size: int = 224, **kw) -> SwinV2:
    return SwinV2(image_size, 4, 96, (2, 2, 18, 2), (3, 6, 12, 24), 7, num_classes, **kw)


def swin_tiny(num_classes: int = 1000, image_size: int = 224, **kw) -> SwinV2:
    """Swin V1 tiny (timm swin_tiny_patch4_window7_224's shape class)."""
    return SwinV2(image_size, 4, 96, (2, 2, 6, 2), (3, 6, 12, 24), 7, num_classes, v1=True, **kw)
