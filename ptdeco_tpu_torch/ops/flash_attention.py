"""Causal flash attention on (batch, heads, seq, head_dim) tensors.

Counterpart of ``ptdeco_tpu/ops/flash_attention.py``.  On a CUDA tensor
the forward launches the hand-written Hopper kernel
(``csrc/flash_attention_fwd.cu``) and the backward recomputes through the
plain version, exactly as the JAX op's ``_bwd`` does; on a CPU tensor the
plain version runs.  k and v may carry fewer (grouped) heads than q:
query head h reads kv head ``h // (heads // kv_heads)``.  The kernel reads
q, k and v through TMA tensor maps with the caller's strides, so the
model's transposed (b, s, h, d) views are read as they lie and the output
takes q's layout; a tensor whose strides TMA cannot address is first
copied contiguous (``_tma_layout``).  A head dim of 80 or 96 runs the
128-wide instance with its tensor maps 80 or 96 wide: TMA zero-fills the
columns past them, up to 127, of Q, K and V, which add nothing to Q K^T,
and only the real columns of O are stored.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

__all__ = [
    "flash_attention",
    "causal_attention_plain",
    "KERNEL_HEAD_DIMS",
    "flash_schedule",
    "block_n",
    "smem_bytes",
    "tile_head_dim",
]

# head_dim values the kernel takes: 64, 128 and 256 are template instances
# of their own; 80 and 96 run the 128 instance (``tile_head_dim``)
KERNEL_HEAD_DIMS = (64, 80, 96, 128, 256)
# query rows a CTA takes at a time, K/V ring depth
# (csrc/flash_attention_fwd.cu: kBM, kStages)
BLOCK_M, STAGES = 128, 2


def tile_head_dim(head_dim: int) -> int:
    """The head dim of the template instance that runs ``head_dim``: its
    own, or 128 for 80 and 96 (one and a quarter or one and a half 64-column
    swizzle atoms a row; the tensor maps' zero fill pads it to two)."""
    return 128 if head_dim in (80, 96) else head_dim


def block_n(head_dim: int) -> int:
    """Keys a K/V tile holds (``Layout<D>::kBN``): 128, and 64 at head dim
    256, where a 128-key ring would not fit a CTA's shared memory."""
    return 64 if head_dim == 256 else 128


def smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one CTA: the Q tile, the K and V ring, the
    mbarriers (Q full and empty, K and V full and empty a stage), 1 KB of
    alignment slack; at the instance's head dim (``tile_head_dim``)."""
    head_dim = tile_head_dim(head_dim)
    tiles = BLOCK_M * head_dim + 2 * STAGES * block_n(head_dim) * head_dim
    return tiles * 2 + (2 + 4 * STAGES) * 8 + 1024


def flash_schedule(b: int, h: int, s: int, n_ctas: int) -> list[list[tuple[int, int]]]:
    """The ``(batch * heads + head, q-tile)`` tiles each CTA of the kernel's
    persistent grid takes, in order.  The grid is ``min(tiles, n_ctas)``
    CTAs (the kernel passes the card's SM count); tile t of the walk is
    head ``t % (b * h)`` and q-tile ``n_q - 1 - t // (b * h)``, so the
    tiles with the most causal key tiles (``(qt + 1) * BLOCK_M / block_n``)
    come first, and CTA
    c takes tiles c, c + grid, ...  (csrc/flash_attention_fwd.cu:TileOf)."""
    n_q, bh = -(-s // BLOCK_M), b * h
    walk = [(t % bh, n_q - 1 - t // bh) for t in range(bh * n_q)]
    grid = min(len(walk), n_ctas)
    return [walk[c::grid] for c in range(grid)]


def _repeat_kv(t: torch.Tensor, heads: int) -> torch.Tensor:
    rep = heads // t.shape[1]
    return t if rep == 1 else torch.repeat_interleave(t, rep, dim=1)


def causal_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sm_scale: float,
    attn_mask: Optional[torch.Tensor] = None,
    key_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """f32 logits masked with the f32 minimum, softmax, probabilities cast
    to q's dtype, then PV (``_reference_causal``).  ``attn_mask`` (b, s),
    zero at padding keys, is the model's einsum path (transformer.py:4118
    onward) for padded batches; ``key_bias``, broadcast to (b, h, s, s)
    (ALiBi's (b, h, 1, s)), is added to the scaled logits before the
    mask."""
    h, s = q.shape[1], q.shape[2]
    k, v = _repeat_kv(k, h), _repeat_kv(v, h)
    logits = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
    logits = logits * sm_scale
    if key_bias is not None:
        logits = logits + key_bias
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    if attn_mask is not None:
        mask = mask & attn_mask[:, None, None, :].to(torch.bool)
    logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs.to(torch.float32), v.to(torch.float32)).to(q.dtype)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_void_p] * 2


def _tma_strides(t: torch.Tensor) -> Optional[list[int]]:
    """The (batch, head, seq) element strides of ``t`` as its TMA tensor map
    takes them, or None where TMA cannot address it: head_dim must be
    contiguous, the start 16-byte aligned and every stride a positive
    multiple of 8 elements.  A size-1 dimension's stride is never used, so
    it is given as head_dim."""
    if t.stride(-1) != 1 or t.data_ptr() % 16:
        return None
    strides = [t.stride(i) if t.shape[i] > 1 else t.shape[-1] for i in range(3)]
    return strides if all(st > 0 and st % 8 == 0 for st in strides) else None


def _tma_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` as it lies when TMA can address it, else a contiguous aligned
    copy (which it always can, at the kernel's head_dims)."""
    return t if _tma_strides(t) is not None else _build.aligned(t)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad shapes {q.shape} {k.shape} {v.shape}")
    b, h, s, d = q.shape
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError("flash_attention: the kernel takes bf16 q, k, v")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {KERNEL_HEAD_DIMS}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if not (math.isfinite(sm_scale) and sm_scale > 0):
        raise ValueError(f"flash_attention: the kernel takes a positive sm_scale, not {sm_scale}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float) -> torch.Tensor:
    _check(q, k, v, sm_scale)
    q, k, v = _tma_layout(q), _tma_layout(k), _tma_layout(v)
    b, h, s, d = q.shape
    o = torch.empty_like(q)  # q's layout: the model's transposed view stays one
    if o.numel() == 0:
        return o
    strides = [_tma_strides(t) for t in (q, k, v, o)]
    if strides[3] is None:  # empty_like of an addressable q is addressable
        raise RuntimeError(f"flash_attention: output strides {o.stride()} not addressable")
    packed = (ctypes.c_longlong * 12)(*(st for t in strides for st in t))
    fn = _build.kernel_function("flash_attention_fwd", "ptdeco_flash_attention_fwd", _ARGTYPES)
    _build.launch("flash_attention", fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  o.data_ptr(), b, h, k.shape[1], s, d, float(sm_scale), packed)
    flash_attention.launches += 1
    return o


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        ctx.save_for_backward(q, k, v)
        ctx.sm_scale = sm_scale
        return _launch(q, k, v, sm_scale)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = causal_attention_plain(*qkv, ctx.sm_scale)
            grads = torch.autograd.grad(out, qkv, grad_out)
        return (*grads, None)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float
) -> torch.Tensor:
    """Causal attention; q (b, h, s, d), k and v (b, h_kv, s, d)."""
    if q.device.type == "cpu":
        return causal_attention_plain(q, k, v, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _FlashAttention.apply(q, k, v, sm_scale)


flash_attention.launches = 0
