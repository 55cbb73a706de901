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
as they are and walks ``group_sizes`` on the card: it masks each group's
ragged edge, and a tile slot past the last group returns at once, so an
unrouted expert's grid is not read.  It has two routes, chosen by shape
alone (``kernel_route``): ``"decode"`` for a few rows a group (weight rows
as the MMA's M side, K split over a cluster so that the units cover the
card, ``decode_split``) and ``"batch"`` for larger groups (TMA + wgmma with
the weights converted into register A fragments).  On a CPU
tensor the plain version runs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from . import _build
from .gmm import MAX_TMA_EXPERTS, block_rows

__all__ = [
    "grouped_matmul_int8",
    "grouped_matmul_int8_plain",
    "kernel_route",
    "batch_rows",
    "decode_split",
    "decode_schedule",
]

# the decode route (csrc/gmm_int8.cu:DecodeTile): a slot of at most 16
# group rows against 64 weight rows, K split over a cluster of at most 8
# CTAs, each streaming stages of 512 bytes of its weight rows
DECODE_ROWS = 16
DECODE_COLS = 64
DECODE_BLOCK_K = 512
MAX_SPLIT = 8
# CTAs a decode launch aims for on each SM (a few waves of the two an SM
# holds), so that a wave's tail is a small share of the run
DECODE_CTAS_PER_SM = 4
# the batch route (csrc/gmm_int8.cu:batch_kernel): 128 weight rows against
# a tile of 128 or 256 group rows, the smaller when it holds a mean group
BATCH_TILE_ROWS = (128, 256)


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


def kernel_route(m: int, k: int, n: int, n_experts: int) -> str:
    """The int8 kernel's route for ``m`` rows of ``k`` over ``n_experts``
    (n, k) grids: ``"decode"`` when a mean group fits one 16-row slot (the
    decode steps), and for every shape the batch route cannot take (K not a
    multiple of 16 or N of 8, which TMA's 16-byte pitch and the 16-byte
    row stores need, or more than MAX_TMA_EXPERTS experts); otherwise
    ``"batch"``."""
    if block_rows(m, n_experts, (DECODE_ROWS, *BATCH_TILE_ROWS)) == DECODE_ROWS:
        return "decode"
    if k == 0 or k % 16 or n % 8 or not 1 <= n_experts <= MAX_TMA_EXPERTS:
        return "decode"
    return "batch"


def batch_rows(m: int, n_experts: int) -> int:
    """The batch route's tile of group rows: 128 when it holds a mean group,
    else 256 (measured: 64-row tiles read a group's weights once per 64
    rows, and 256-row tiles pad a 64-row group fourfold)."""
    return block_rows(m, n_experts, BATCH_TILE_ROWS)


def decode_split(m: int, k: int, n: int, n_experts: int, sms: int,
                 block_k: int = DECODE_BLOCK_K, cols: int = DECODE_COLS) -> tuple[int, int]:
    """``(ks, steps)``: the decode route splits K over ``ks`` CTAs (1 to 8,
    one cluster), each taking ``steps`` stages of ``block_k`` bytes (the
    last split what is left).  Sized from the shapes and the SM count
    alone, with no host sync: the 16-row slots that can hold routed rows
    (at most m, and ceil(m / 16) + E: one partial slot a group) times the
    ``cols``-column tiles are the units, and K is split until the grid holds
    DECODE_CTAS_PER_SM CTAs an SM, but never into splits without a
    stage."""
    k_steps = -(-k // block_k)
    if k_steps == 0:
        return 1, 0
    slots = min(m, -(-m // DECODE_ROWS) + n_experts)
    units = max(1, slots) * -(-n // cols)
    ks = max(1, min(MAX_SPLIT, k_steps, -(-DECODE_CTAS_PER_SM * sms // units)))
    steps = -(-k_steps // ks)
    return -(-k_steps // steps), steps


def decode_schedule(group_sizes: Sequence[int], m: int, k: int, n: int, ks: int, steps: int,
                    block_k: int = DECODE_BLOCK_K, cols: int = DECODE_COLS
                    ) -> list[tuple[int, int, int, int, int, int]]:
    """The CTAs of the decode route that work, in launch order: ``(expert,
    r0, r1, n0, k0, k1)``, rows [r0, r1) of one expert's group against
    weight rows [n0, n0 + cols) over k in [k0, k1).  The grid is (ks x
    (ceil(m / 16) + E) slots) x ceil(n / cols) tiles; CTA x is split x % ks
    of slot x // ks (``gmm_tile.cuh:group_slot``: the 16-row tiles of the
    groups laid end to end, each group cut on its own, nothing past the last
    group's last tile)."""
    slots = []
    off = 0
    for e, size in enumerate(group_sizes):
        size = max(int(size), 0)
        for r0 in range(off, off + size, DECODE_ROWS):
            r1 = min(r0 + DECODE_ROWS, off + size, m)
            if r0 < r1:
                slots.append((e, r0, r1))
        off += size
    n_slots = -(-m // DECODE_ROWS) + len(group_sizes)
    out = []
    for y in range(-(-n // cols)):
        for x in range(ks * n_slots):
            slot, split = divmod(x, ks)
            if slot < len(slots):
                k0 = split * steps * block_k
                out.append((*slots[slot], y * cols, min(k0, k),
                            min(k, k0 + steps * block_k)))
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_DECODE_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p] + [
    ctypes.c_int] * 7 + [ctypes.c_void_p]
_BATCH_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p] + [
    ctypes.c_int] * 4 + [ctypes.c_void_p]


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
    s_table = _build.pointer_table(scales)
    sizes = group_sizes.to(torch.int32).contiguous()
    route = kernel_route(m, k, n, e)
    if route == "batch":
        # the grids' tensor maps, encoded once for these grids
        maps = _build.tensor_map_table("gmm_int8", "ptdeco_gmm_int8_encode_weights", w_q, n, k)
        fn = _build.kernel_function("gmm_int8", "ptdeco_gmm_int8_batch", _BATCH_ARGTYPES)
        _build.launch("grouped_matmul_int8", fn, lhs.device, lhs.data_ptr(), maps.data_ptr(),
                      s_table.data_ptr(), sizes.data_ptr(), e, out.data_ptr(), m, k, n,
                      batch_rows(m, e))
    else:
        index = lhs.device.index if lhs.device.index is not None else torch.cuda.current_device()
        ks, steps = decode_split(m, k, n, e, _sm_count(index), DECODE_BLOCK_K, DECODE_COLS)
        fn = _build.kernel_function("gmm_int8", "ptdeco_gmm_int8_decode", _DECODE_ARGTYPES)
        _build.launch("grouped_matmul_int8", fn, lhs.device, lhs.data_ptr(),
                      _build.pointer_table(w_q).data_ptr(), s_table.data_ptr(),
                      sizes.data_ptr(), e, out.data_ptr(), m, k, n, ks, steps, DECODE_COLS,
                      DECODE_BLOCK_K)
    grouped_matmul_int8.launches += 1
    grouped_matmul_int8.route_launches[route] += 1
    return out


grouped_matmul_int8.launches = 0
# launches by route, for tests and chip_smoke.py to show which route ran
grouped_matmul_int8.route_launches = {"decode": 0, "batch": 0}
