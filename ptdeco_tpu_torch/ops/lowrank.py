"""Fused low-rank forward ``y = (x @ K1) @ K2 + b``.

Counterpart of ``ptdeco_tpu/ops/lowrank_pallas.py``.  ``k1`` is (d_in, r)
and ``k2`` is (r, d_out), the JAX package's layout; a factor pair's
``nn.Linear`` weights are their transposes, which the kernel reads as they
lie.  On a CUDA tensor ``lowrank_matmul`` launches the hand-written Hopper
kernel (``csrc/lowrank_matmul.cu``) for every shape: the TPU version's
small-shape gate (n < 256, d_out < 512, r < 128 or > 12 MB fall to XLA) was
measured on a TPU and is not carried over.  The kernel takes bf16 (tensor
cores, ranks up to ``MAX_RANK``) and f32 (exact f32 on the CUDA cores, ranks
up to ``MAX_RANK_F32``), as the Pallas kernel takes either; the rank limit
is the hidden's shared memory, the counterpart of the Pallas kernel's VMEM
gate.  ``kernel_takes`` states the rule; ``nn/fuse.py`` fuses only the pairs
it admits.  On a CPU tensor the plain version runs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import _build

__all__ = [
    "lowrank_matmul",
    "lowrank_matmul_plain",
    "kernel_takes",
    "launch_shape",
    "LaunchShape",
    "smem_bytes",
    "smem_bytes_f32",
    "MAX_RANK",
    "MAX_RANK_F32",
    "MAX_SHARED_BYTES",
]

# shared memory one block may use on Hopper (227 KB)
MAX_SHARED_BYTES = 232448
SM_SHARED_BYTES = 233472  # shared memory of one H100 SM (228 KB)
# CTAs a launch aims to put in flight (about one for each of an H100's
# 132 SMs, of the two an SM can hold)
TARGET_CTAS = 128
# every column group recomputes its row tile's hidden, so a group takes at
# least this many output columns a CTA (a decode step ran fastest with
# fewer, wider groups; tools/lowrank_sweep.py)
MIN_COLS_PER_CTA = 64
ROW_TILES = (8, 16, 32, 64)  # rows a CTA takes (csrc/lowrank_matmul.cu)
MAX_CLUSTER = 8
MAX_ROW_TILES = 65535  # the grid's y extent, one row tile each
_NT, _BK, _STAGES = 128, 64, 3  # the kernel's tile width, k-step and ring depth


class LaunchShape(NamedTuple):
    bm: int  # rows a CTA takes
    cluster: int  # CTAs splitting the d_in contraction of one row tile
    groups: int  # column groups, each recomputing its row tile's hidden
    cols_per_cta: int  # output columns a CTA writes (a multiple of 8)
    row_tiles: int

    @property
    def ctas(self) -> int:
        return self.cluster * self.groups * self.row_tiles


def smem_bytes(bm: int, r: int) -> int:
    """Dynamic shared memory of one CTA (``smem_bytes`` in the kernel): the
    3-stage ring of (bm + 128) x 64 bf16 tiles (in phase 2 the warps' own
    rings and output staging), the bf16 hidden of bm x (r padded to 64,
    + 8), the f32 partial of bm x (one hidden chunk of at most 128
    columns, + 4), and 27 mbarriers."""
    r_pad = -(-r // _BK) * _BK
    return (_STAGES * (bm + _NT) * _BK * 2 + bm * (r_pad + 8) * 2
            + bm * (min(r_pad, _NT) + 4) * 4 + (_STAGES + 8 * _STAGES) * 8)


# the largest rank that fits at the smallest row tile
MAX_RANK = max(r for r in range(_BK, 16384, _BK)
               if smem_bytes(ROW_TILES[0], r) <= MAX_SHARED_BYTES)


_F32_ROWS, _F32_COLS, _F32_LD, _F32_STAGES = 16, 64, 68, 3  # the f32 path's tiles


def smem_bytes_f32(r: int) -> int:
    """Dynamic shared memory of one CTA of the f32 path: a 3-stage ring of
    (16 + 64) x 68-float operand tiles, and the f32 hidden of 16 rows x
    (r padded to 64, + 4) (``f32_smem_bytes`` in the kernel)."""
    r_pad = -(-r // _F32_COLS) * _F32_COLS
    return (_F32_STAGES * (_F32_ROWS + _F32_COLS) * _F32_LD + _F32_ROWS * (r_pad + 4)) * 4


MAX_RANK_F32 = max(r for r in range(_F32_COLS, 16384, _F32_COLS)
                   if smem_bytes_f32(r) <= MAX_SHARED_BYTES)


def _ctas_per_sm(bm: int, r: int) -> int:
    """CTAs of the kernel an SM holds at once: shared memory (228 KB an SM,
    1 KB reserved a block) and registers (8 warps at 128 registers fill
    half of an SM's) both allow at most two."""
    return min(2, SM_SHARED_BYTES // (smem_bytes(bm, r) + 1024))


def _max_rank(dtype: torch.dtype) -> int:
    return {torch.bfloat16: MAX_RANK, torch.float32: MAX_RANK_F32}.get(dtype, 0)


def kernel_takes(dtype: torch.dtype, r: int) -> bool:
    """Whether the kernel takes a pair of ``dtype`` at rank r: bf16 up to
    ``MAX_RANK``, f32 up to ``MAX_RANK_F32``."""
    return 1 <= r <= _max_rank(dtype)


def _check_rank(r: int, dtype: torch.dtype = torch.bfloat16) -> None:
    if r < 1:
        raise ValueError(f"lowrank_matmul: rank {r} < 1")
    if r > _max_rank(dtype):
        need = smem_bytes(ROW_TILES[0], r) if dtype == torch.bfloat16 else smem_bytes_f32(r)
        raise ValueError(
            f"lowrank_matmul: rank {r} needs {need} bytes of shared memory per block, over "
            f"the {MAX_SHARED_BYTES} a block may use (the kernel takes {dtype} ranks up to "
            f"{_max_rank(dtype)})"
        )


def launch_shape_f32(n: int, d_out: int) -> tuple[int, int]:
    """(column groups, columns a CTA) of the f32 path for n rows: 16-row
    tiles, and column groups of whole 64-column passes until about
    TARGET_CTAS CTAs are in flight (each group recomputes its tile's
    hidden)."""
    row_tiles = -(-n // _F32_ROWS)
    passes = -(-d_out // _F32_COLS)
    groups = max(1, min(TARGET_CTAS // row_tiles, passes))
    cols = -(-passes // groups) * _F32_COLS
    return -(-d_out // cols), cols


@functools.lru_cache(maxsize=256)
def launch_shape(n: int, d_in: int, r: int, d_out: int) -> LaunchShape:
    """Grid of the fused kernel for n rows.

    The row tile is the smallest that holds n (64 above), halved while the
    hidden does not fit or, where n takes several tiles anyway, until two
    CTAs fit on an SM.  The cluster splits d_in (at most one CTA per
    64-wide step, at most 8) and column groups split d_out (at least
    MIN_COLS_PER_CTA columns a CTA) until about TARGET_CTAS CTAs are in
    flight; larger clusters first, since they share one row tile's hidden.
    With two CTAs an SM, 30 clusters of 8 fit on the card at once (15 with
    one: a grid of 16 then ran in two waves), so the grid runs in one
    wave; tools/lowrank_sweep.py times the alternatives."""
    if n < 1 or d_out < 1 or d_in < 0:
        raise ValueError(f"lowrank_matmul: no launch for n {n} d_in {d_in} d_out {d_out}")
    _check_rank(r)
    bm = next((b for b in ROW_TILES if b >= n), ROW_TILES[-1])
    while bm > ROW_TILES[0] and (
        smem_bytes(bm, r) > MAX_SHARED_BYTES or (n > bm and _ctas_per_sm(bm, r) < 2)
    ):
        bm //= 2
    row_tiles = -(-n // bm)
    if row_tiles > MAX_ROW_TILES:
        raise ValueError(f"lowrank_matmul: {n} rows need {row_tiles} row tiles of {bm}, over "
                         f"the grid's {MAX_ROW_TILES} (the kernel takes up to "
                         f"{MAX_ROW_TILES * ROW_TILES[-1]} rows)")
    k_steps = max(1, -(-d_in // _BK))
    cluster = 1
    while cluster * 2 <= min(MAX_CLUSTER, k_steps) and row_tiles * cluster * 2 <= TARGET_CTAS:
        cluster *= 2
    groups = max(1, min(TARGET_CTAS // (cluster * row_tiles),
                        d_out // (MIN_COLS_PER_CTA * cluster)))
    cols_per_cta = -(-d_out // (groups * cluster * 8)) * 8
    return LaunchShape(bm, cluster, groups, cols_per_cta, row_tiles)


def lowrank_matmul_plain(
    x: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor, bias: Optional[torch.Tensor]
) -> torch.Tensor:
    """``lowrank_xla``: f32 products, hidden rounded to x's dtype."""
    h = (x.to(torch.float32) @ k1.to(torch.float32)).to(x.dtype)
    y = h.to(torch.float32) @ k2.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_ARGTYPES_F32 = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def lowrank_matmul(
    x: torch.Tensor,
    k1: torch.Tensor,
    k2: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused ``(x @ K1) @ K2 + b`` for x of shape (..., d_in)."""
    lead, d_in = x.shape[:-1], x.shape[-1]
    r, d_out = k1.shape[1], k2.shape[1]
    x2 = x.reshape(lead.numel(), d_in)
    if x.device.type == "cpu":
        return lowrank_matmul_plain(x2, k1, k2, bias).reshape(*lead, d_out)
    if x.device.type != "cuda":
        raise ValueError(f"lowrank_matmul: unsupported device {x.device}")
    if k1.shape[0] != d_in or k2.shape[0] != r or (bias is not None and bias.shape != (d_out,)):
        raise ValueError(
            f"lowrank_matmul: shapes x {tuple(x.shape)} k1 {tuple(k1.shape)} "
            f"k2 {tuple(k2.shape)} do not chain"
        )
    tensors = [x2, k1, k2] + ([bias] if bias is not None else [])
    if x.dtype not in (torch.bfloat16, torch.float32) or any(
        t.dtype != x.dtype or t.device != x.device for t in tensors
    ):
        raise ValueError("lowrank_matmul: the kernel takes bf16 or f32 tensors of one dtype "
                         "on one device")
    _check_rank(r, x.dtype)
    xk = _build.aligned(x2)
    if xk.data_ptr() != x.data_ptr():  # rows that were not a row-major view
        lowrank_matmul.input_copies += 1
    x2 = xk
    w1 = _build.aligned(k1.t())  # (r, d_in): a no-op for a Linear weight's view
    w2 = _build.aligned(k2.t())  # (d_out, r)
    b = _build.aligned(bias) if bias is not None else None
    n = x2.shape[0]
    out = torch.empty((n, d_out), dtype=x.dtype, device=x.device)
    if n == 0 or d_out == 0:
        return out.reshape(*lead, d_out)
    ptrs = (x2.data_ptr(), w1.data_ptr(), w2.data_ptr(), b.data_ptr() if b is not None else None,
            out.data_ptr(), n, d_in, r, d_out)
    if x.dtype == torch.float32:
        fn = _build.kernel_function("lowrank_matmul", "ptdeco_lowrank_matmul_f32", _ARGTYPES_F32)
        _build.launch("lowrank_matmul", fn, x.device, *ptrs, *launch_shape_f32(n, d_out))
    else:
        shape = launch_shape(n, d_in, r, d_out)
        fn = _build.kernel_function("lowrank_matmul", "ptdeco_lowrank_matmul", _ARGTYPES)
        _build.launch("lowrank_matmul", fn, x.device, *ptrs,
                      shape.bm, shape.cluster, shape.groups, shape.cols_per_cta)
    lowrank_matmul.launches += 1
    return out.reshape(*lead, d_out)


lowrank_matmul.launches = 0
lowrank_matmul.input_copies = 0
