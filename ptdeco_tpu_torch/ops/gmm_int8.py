"""Grouped matmul over weight-only int8 experts.

Counterpart of ``ptdeco_tpu/ops/gmm_int8.py``.  For rows sorted by expert,
with ``group_sizes`` (E,) int32 as for ``gmm.grouped_matmul``,

    out[i] = (lhs[i] @ w_q[e_i]ᵀ) * scale[e_i]        e_i = row i's expert

with the int8 weights converted to the activation dtype on chip and the
per-output-channel scale applied once to the f32 sum.  Weights are given
per expert in ``nn.Linear``'s (out, in) layout, with (out,) f32 scales.

The JAX kernel takes rows scattered so that every group starts on an m-tile
(its ``pad_groups_for_tiles``), with trailing empty tiles clamped to the
last expert.  The kernel here (``csrc/gmm_int8.cu``) reads the sorted rows
as they are and walks ``group_sizes`` on the card as the bf16 grouped kernel
does: it masks each group's ragged edge, and a tile slot past the last group
returns at once, so an unrouted expert's grid is not read.  The m-tile is
chosen for the H100 (16 rows at decode) where the TPU used 128/256.  On a
CPU tensor the plain version runs.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build
from .gmm import block_rows

__all__ = ["grouped_matmul_int8", "grouped_matmul_int8_plain"]

KERNEL_BLOCK_ROWS = (16, 64)


def grouped_matmul_int8_plain(
    lhs: torch.Tensor,
    w_q: Sequence[torch.Tensor],
    scales: Sequence[torch.Tensor],
    group_sizes: torch.Tensor,
) -> torch.Tensor:
    """One f32 product per expert, scaled in f32 and rounded to lhs's dtype;
    rows past the last group are zero."""
    out = torch.zeros((lhs.shape[0], w_q[0].shape[0]), dtype=lhs.dtype, device=lhs.device)
    start = 0
    for w, s, size in zip(w_q, scales, group_sizes.tolist()):
        if size:
            rows = slice(start, start + size)
            y = lhs[rows].to(torch.float32) @ w.to(torch.float32).t()
            out[rows] = (y * s.to(torch.float32)).to(lhs.dtype)
        start += size
    return out


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4 + [
    ctypes.c_void_p
]


def grouped_matmul_int8(
    lhs: torch.Tensor,
    w_q: Sequence[torch.Tensor],
    scales: Sequence[torch.Tensor],
    group_sizes: torch.Tensor,
) -> torch.Tensor:
    """lhs (M, K) against E int8 grids (N, K) with (N,) scales, by group sizes."""
    if lhs.device.type == "cpu":
        return grouped_matmul_int8_plain(lhs, w_q, scales, group_sizes)
    if lhs.device.type != "cuda":
        raise ValueError(f"grouped_matmul_int8: unsupported device {lhs.device}")
    e = len(w_q)
    if lhs.dim() != 2 or e == 0 or len(scales) != e or group_sizes.shape != (e,):
        raise ValueError(
            f"grouped_matmul_int8: lhs {tuple(lhs.shape)}, {e} grids, {len(scales)} "
            f"scales, group_sizes {tuple(group_sizes.shape)}"
        )
    m, k = lhs.shape
    n = w_q[0].shape[0]
    if any(w.shape != (n, k) or w.dtype != torch.int8 for w in w_q):
        raise ValueError(f"grouped_matmul_int8: every grid must be ({n}, {k}) int8")
    if any(s.shape != (n,) or s.dtype != torch.float32 for s in scales):
        raise ValueError(f"grouped_matmul_int8: every scale must be ({n},) float32")
    if lhs.dtype != torch.bfloat16:
        raise ValueError("grouped_matmul_int8: the kernel takes bf16 activations")
    if any(t.device != lhs.device for t in (*w_q, *scales, group_sizes)):
        raise ValueError("grouped_matmul_int8: tensors on different devices")
    out = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    if m == 0 or n == 0:
        return out
    lhs = _build.aligned(lhs)
    w_q = [_build.aligned(w) for w in w_q]
    scales = [_build.aligned(s) for s in scales]
    w_table = _build.pointer_table(w_q)
    s_table = _build.pointer_table(scales)
    sizes = group_sizes.to(torch.int32).contiguous()
    fn = _build.kernel_function("gmm_int8", "ptdeco_gmm_int8", _ARGTYPES)
    _build.launch("grouped_matmul_int8", fn, lhs.device, lhs.data_ptr(), w_table.data_ptr(),
                  s_table.data_ptr(), sizes.data_ptr(), e, out.data_ptr(), m, k, n,
                  block_rows(m, e, KERNEL_BLOCK_ROWS))
    grouped_matmul_int8.launches += 1
    return out


grouped_matmul_int8.launches = 0
