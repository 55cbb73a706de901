"""Fused low-rank forward ``y = (x @ K1) @ K2 + b``.

Counterpart of ``ptdeco_tpu/ops/lowrank_pallas.py``.  ``k1`` is (d_in, r)
and ``k2`` is (r, d_out), the JAX package's layout; a factor pair's
``nn.Linear`` weights are their transposes, which the kernel reads as they
lie.  On a CUDA tensor ``lowrank_matmul`` launches the hand-written Hopper
kernel (``csrc/lowrank_matmul.cu``) for every shape: the TPU version's
small-shape gate (n < 256, d_out < 512, r < 128 or > 12 MB fall to XLA) was
measured on a TPU and is not carried over.  The kernel takes bf16 (tensor
cores, ranks up to ``MAX_RANK``) and f32 (3xTF32 products on the tensor
cores, an f32 hidden, ranks up to ``MAX_RANK_F32``), as the Pallas kernel
takes either; the rank limit is the hidden's shared memory, the counterpart of the Pallas kernel's VMEM
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
    "lowrank_linear",
    "lowrank_matmul_plain",
    "kernel_takes",
    "launch_shape",
    "launch_shape_f32",
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


# the f32 path (csrc/lowrank_matmul.cu, lowrank_f32_kernel): row tiles, the
# k-step (32 floats, one 128-byte row), the hidden chunk, a warp's output
# unit in phase 2, and a row of the partials (k slices of a chunk, + 4 each)
ROW_TILES_F32 = (16, 32, 64)
_F32_BK, _F32_NT, _F32_UNIT, _F32_PART_LD = 32, 128, 16, 128 + 16
SM_COUNT = 132  # an H100 SXM's SMs


def smem_bytes_f32(bm: int, r: int) -> int:
    """Dynamic shared memory of one CTA of the f32 path at bm rows
    (``f32_smem_bytes`` in the kernel): a 3-stage ring whose stage holds
    the x tile and one hidden chunk of W1 (bm + min(r padded to 32, 128)
    rows of 32 floats), or in phase 2 the eight warps' 16-row W2 tiles
    (128 rows), whichever is more; the f32 hidden of bm x (r padded to 32,
    + 4); the partials, bm x 144; and 27 mbarriers."""
    r_pad = -(-r // _F32_BK) * _F32_BK
    stage_rows = max(bm + min(r_pad, _F32_NT), 8 * _F32_UNIT)
    return (_STAGES * stage_rows * _F32_BK + bm * (r_pad + 4) + bm * _F32_PART_LD) * 4 \
        + (_STAGES + 8 * _STAGES) * 8


# the largest rank that fits at the smallest row tile
MAX_RANK_F32 = max(r for r in range(_F32_BK, 16384, _F32_BK)
                   if smem_bytes_f32(ROW_TILES_F32[0], r) <= MAX_SHARED_BYTES)


def _ctas_per_sm(bm: int, r: int) -> int:
    """CTAs of the kernel an SM holds at once: shared memory (228 KB an SM,
    1 KB reserved a block) and registers (8 warps at 128 registers fill
    half of an SM's) both allow at most two."""
    return min(2, SM_SHARED_BYTES // (smem_bytes(bm, r) + 1024))


def _ctas_per_sm_f32(bm: int, r: int) -> int:
    """CTAs of the f32 path an SM holds at once: at most two (8 warps at
    128 registers fill half of an SM's), fewer where shared memory is
    short."""
    return min(2, SM_SHARED_BYTES // (smem_bytes_f32(bm, r) + 1024))


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
        need = (smem_bytes(ROW_TILES[0], r) if dtype == torch.bfloat16
                else smem_bytes_f32(ROW_TILES_F32[0], r))
        raise ValueError(
            f"lowrank_matmul: rank {r} needs {need} bytes of shared memory per block, over "
            f"the {MAX_SHARED_BYTES} a block may use (the kernel takes {dtype} ranks up to "
            f"{_max_rank(dtype)})"
        )


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


@functools.lru_cache(maxsize=256)
def launch_shape_f32(n: int, d_in: int, r: int, d_out: int) -> LaunchShape:
    """Grid of the f32 path for n rows.

    Every CTA of a cluster holds its row tile's whole hidden, so phase 1
    runs once a row tile; column groups recompute it, and come only where
    SMs would otherwise be idle.  The row tile is the largest (64 rows)
    whose row tiles, times the largest cluster d_in allows (8, and at most
    one CTA per 32-wide step), still reach the card's SM_COUNT SMs,
    halved while the hidden does not fit or, where n takes several tiles
    anyway, until two CTAs fit on an SM.  The cluster then doubles while
    the grid stays within one wave (SM_COUNT times the CTAs an SM holds),
    and column groups (at least MIN_COLS_PER_CTA columns a CTA) fill the
    SMs still idle; tools/lowrank_sweep.py --f32 times the alternatives."""
    if n < 1 or d_out < 1 or d_in < 0:
        raise ValueError(f"lowrank_matmul: no launch for n {n} d_in {d_in} d_out {d_out}")
    _check_rank(r, torch.float32)
    k_steps = max(1, -(-d_in // _F32_BK))
    most = 1
    while most * 2 <= min(MAX_CLUSTER, k_steps):
        most *= 2
    bm = ROW_TILES_F32[-1]
    while bm > ROW_TILES_F32[0] and (
        smem_bytes_f32(bm, r) > MAX_SHARED_BYTES
        or -(-n // bm) * most < SM_COUNT
        or (n > bm and _ctas_per_sm_f32(bm, r) < 2)
    ):
        bm //= 2
    row_tiles = -(-n // bm)
    slots = SM_COUNT * _ctas_per_sm_f32(bm, r)
    cluster = 1
    while cluster * 2 <= most and row_tiles * cluster * 2 <= slots:
        cluster *= 2
    groups = max(1, min(SM_COUNT // (cluster * row_tiles),
                        d_out // (MIN_COLS_PER_CTA * cluster)))
    cols_per_cta = -(-d_out // (groups * cluster * _F32_UNIT)) * _F32_UNIT
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


def lowrank_matmul(
    x: torch.Tensor,
    k1: torch.Tensor,
    k2: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused ``(x @ K1) @ K2 + b`` for x of shape (..., d_in)."""
    return lowrank_linear(x, k1.t(), k2.t(), bias)


def lowrank_linear(
    x: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``lowrank_matmul`` with the factors as a pair's ``nn.Linear`` weights
    hold them: w1 (r, d_in), w2 (d_out, r), the layout the kernel reads
    (``nn.FusedLowRankLinear`` calls it).  Counted as ``lowrank_matmul``'s
    launches."""
    lead, d_in = x.shape[:-1], x.shape[-1]
    r, d_out = w1.shape[0], w2.shape[0]
    x2 = x.reshape(lead.numel(), d_in)
    if not x.is_cuda:
        if x.device.type == "cpu":
            return lowrank_matmul_plain(x2, w1.t(), w2.t(), bias).reshape(*lead, d_out)
        raise ValueError(f"lowrank_matmul: unsupported device {x.device}")
    if w1.shape[1] != d_in or w2.shape[1] != r or (bias is not None and bias.shape != (d_out,)):
        raise ValueError(
            f"lowrank_matmul: shapes x {tuple(x.shape)} k1 {tuple(w1.t().shape)} "
            f"k2 {tuple(w2.t().shape)} do not chain"
        )
    dtype, dev = x.dtype, x.device
    if (dtype not in (torch.bfloat16, torch.float32) or w1.dtype != dtype or w2.dtype != dtype
            or w1.device != dev or w2.device != dev
            or (bias is not None and (bias.dtype != dtype or bias.device != dev))):
        raise ValueError("lowrank_matmul: the kernel takes bf16 or f32 tensors of one dtype "
                         "on one device")
    _check_rank(r, dtype)
    xk = _build.aligned(x2)
    if xk.data_ptr() != x.data_ptr():  # rows that were not a row-major view
        lowrank_matmul.input_copies += 1
    x2, w1, w2 = xk, _build.aligned(w1), _build.aligned(w2)
    b = _build.aligned(bias) if bias is not None else None
    n = x2.shape[0]
    out = torch.empty((n, d_out), dtype=dtype, device=dev)
    if n == 0 or d_out == 0:
        return out.reshape(*lead, d_out)
    if dtype == torch.float32:
        shape = launch_shape_f32(n, d_in, r, d_out)
        symbol = "ptdeco_lowrank_matmul_f32"
    else:
        shape = launch_shape(n, d_in, r, d_out)
        symbol = "ptdeco_lowrank_matmul"
    fn = _build.kernel_function("lowrank_matmul", symbol, _ARGTYPES)
    _build.launch("lowrank_matmul", fn, dev, x2.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                  b.data_ptr() if b is not None else None, out.data_ptr(), n, d_in, r, d_out,
                  shape.bm, shape.cluster, shape.groups, shape.cols_per_cta)
    lowrank_matmul.launches += 1
    return out.reshape(*lead, d_out)


lowrank_matmul.launches = 0
lowrank_matmul.input_copies = 0
