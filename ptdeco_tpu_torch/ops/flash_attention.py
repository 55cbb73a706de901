"""Causal flash attention on (batch, heads, seq, head_dim) tensors.

Counterpart of ``ptdeco_tpu/ops/flash_attention.py``.  On a CUDA tensor
the forward launches the hand-written Hopper kernel
(``csrc/flash_attention_fwd.cu``) and the backward recomputes through the
plain version, exactly as the JAX op's ``_bwd`` does; on a CPU tensor the
plain version runs.  k and v may carry fewer (grouped) heads than q:
query head h reads kv head ``h // (heads // kv_heads)``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

__all__ = ["flash_attention", "causal_attention_plain", "KERNEL_HEAD_DIMS"]

# head_dim values the kernel is compiled for (a template parameter)
KERNEL_HEAD_DIMS = (64, 128)


def _repeat_kv(t: torch.Tensor, heads: int) -> torch.Tensor:
    rep = heads // t.shape[1]
    return t if rep == 1 else torch.repeat_interleave(t, rep, dim=1)


def causal_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sm_scale: float,
    attn_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """f32 logits masked with the f32 minimum, softmax, probabilities cast
    to q's dtype, then PV (``_reference_causal``).  ``attn_mask`` (b, s),
    zero at padding keys, is the model's einsum path (transformer.py:4118
    onward) for padded batches."""
    h, s = q.shape[1], q.shape[2]
    k, v = _repeat_kv(k, h), _repeat_kv(v, h)
    logits = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
    logits = logits * sm_scale
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    if attn_mask is not None:
        mask = mask & attn_mask[:, None, None, :].to(torch.bool)
    logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs.to(torch.float32), v.to(torch.float32)).to(q.dtype)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
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


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float) -> torch.Tensor:
    _check(q, k, v)
    q, k, v = _build.aligned(q), _build.aligned(k), _build.aligned(v)
    b, h, s, d = q.shape
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    fn = _build.kernel_function("flash_attention_fwd", "ptdeco_flash_attention_fwd", _ARGTYPES)
    _build.launch("flash_attention", fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  o.data_ptr(), b, h, k.shape[1], s, d, float(sm_scale))
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
