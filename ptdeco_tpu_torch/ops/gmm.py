"""Grouped expert matmul ``out[rows of group e] = lhs[rows of group e] @ W_eᵀ``.

Counterpart of the megablox ``gmm`` that ``MoEMLP._grouped`` calls
(``ptdeco_tpu/models/transformer.py:5246-5273``): rows sorted by expert,
``group_sizes`` (E,) int32, bf16 in, f32 accumulate, bf16 out.  The E
weights are given as a sequence of (N, K) matrices, ``nn.Linear``'s own
layout (or one stacked (E, N, K) tensor).  On a CUDA tensor
``grouped_matmul`` launches the hand-written Hopper kernel
(``csrc/grouped_matmul.cu``), which reads the group offsets on the card and
masks each group's ragged edge, so rows are not padded to the TPU's
512-row tile; on a CPU tensor the plain version runs.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build

__all__ = ["grouped_matmul", "grouped_matmul_plain", "block_rows"]


def grouped_matmul_plain(
    lhs: torch.Tensor, weights: Sequence[torch.Tensor], group_sizes: torch.Tensor
) -> torch.Tensor:
    """One f32 product per expert, rounded to lhs's dtype; rows past the
    last group are zero."""
    n = weights[0].shape[0]
    out = torch.zeros((lhs.shape[0], n), dtype=lhs.dtype, device=lhs.device)
    start = 0
    for w, size in zip(weights, group_sizes.tolist()):
        if size:
            rows = slice(start, start + size)
            out[rows] = (lhs[rows].to(torch.float32) @ w.to(torch.float32).t()).to(lhs.dtype)
        start += size
    return out


KERNEL_BLOCK_ROWS = (16, 64, 128)


def block_rows(m: int, n_experts: int, sizes: Sequence[int] = KERNEL_BLOCK_ROWS) -> int:
    """A grouped kernel's m-tile for ``m`` rows over ``n_experts`` groups:
    the smallest of the ascending tile ``sizes`` that holds a mean-sized
    group, else the largest.  Both grouped kernels (bf16 and int8) choose
    their tile here."""
    mean = m / max(n_experts, 1)
    return next((s for s in sizes if mean <= s), sizes[-1])


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4 + [
    ctypes.c_void_p
]


def grouped_matmul(
    lhs: torch.Tensor, weights: Sequence[torch.Tensor], group_sizes: torch.Tensor
) -> torch.Tensor:
    """Grouped matmul of lhs (M, K) against E weights (N, K) by group sizes."""
    if lhs.device.type == "cpu":
        return grouped_matmul_plain(lhs, weights, group_sizes)
    if lhs.device.type != "cuda":
        raise ValueError(f"grouped_matmul: unsupported device {lhs.device}")
    e = len(weights)
    if lhs.dim() != 2 or e == 0 or group_sizes.shape != (e,):
        raise ValueError(
            f"grouped_matmul: lhs {tuple(lhs.shape)}, {e} weights, "
            f"group_sizes {tuple(group_sizes.shape)}"
        )
    m, k = lhs.shape
    n = weights[0].shape[0]
    if any(w.shape != (n, k) for w in weights):
        raise ValueError(f"grouped_matmul: every weight must be ({n}, {k})")
    tensors = [lhs, *weights, group_sizes]
    if any(t.device != lhs.device for t in tensors):
        raise ValueError("grouped_matmul: tensors on different devices")
    if any(t.dtype != torch.bfloat16 for t in (lhs, *weights)):
        raise ValueError("grouped_matmul: the kernel takes bf16 lhs and weights")
    out = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    if m == 0 or n == 0:
        return out
    lhs = _build.aligned(lhs)
    weights = [_build.aligned(w) for w in weights]
    table = _build.pointer_table(weights)
    sizes = group_sizes.to(torch.int32).contiguous()
    fn = _build.kernel_function("grouped_matmul", "ptdeco_grouped_matmul", _ARGTYPES)
    _build.launch("grouped_matmul", fn, lhs.device, lhs.data_ptr(), table.data_ptr(),
                  sizes.data_ptr(), e, out.data_ptr(), m, k, n, block_rows(m, e))
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0
