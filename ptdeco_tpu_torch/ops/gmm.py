"""Grouped expert matmul ``out[rows of group e] = lhs[rows of group e] @ W_eᵀ``.

Counterpart of the megablox ``gmm`` that ``MoEMLP._grouped`` calls
(``ptdeco_tpu/models/transformer.py:5246-5273``): rows sorted by expert,
``group_sizes`` (E,) int32, bf16 in, f32 accumulate, bf16 out.  The E
weights are given as a sequence of (N, K) matrices, ``nn.Linear``'s own
layout (or one stacked (E, N, K) tensor).  On a CUDA tensor
``grouped_matmul`` launches the hand-written Hopper kernel
(``csrc/grouped_matmul.cu``), which reads the group offsets on the card and
masks each group's ragged edge, so rows are not padded to the TPU's
512-row tile; on a CPU tensor the plain version runs.  The kernel has two
routes, chosen by shape alone (``kernel_route``): a TMA + wgmma tile for
the 64- and 128-row m-tiles of prefill, and the ``mma.sync`` tile of
``gmm_tile.cuh`` for the 16-row decode tile and the shapes TMA cannot
address.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build

__all__ = [
    "grouped_matmul",
    "grouped_matmul_plain",
    "block_rows",
    "kernel_route",
    "grouped_schedule",
    "wgmma_smem_bytes",
]


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


# the wgmma route's tile: BM (64 or 128) x 256 columns, BK 64, 4 stages
# (csrc/grouped_matmul.cu:WgTile).  Its experts' tensor maps lie in a device
# table (``_build.tensor_map_table``), at most MAX_TMA_EXPERTS of them (the
# int8 kernel's batch route's too): DeepSeek-V3's 256 routed experts, twice
# the 128 of Qwen3-MoE, the most of the models the port builds
WGMMA_BLOCK_COLS = 256
WGMMA_BLOCK_K = 64
WGMMA_STAGES = 4
MAX_TMA_EXPERTS = 256


def kernel_route(m: int, k: int, n: int, n_experts: int) -> str:
    """The grouped kernel's route for ``m`` rows of ``k`` over ``n_experts``
    (n, k) weights: ``"wgmma"`` (TMA + wgmma) for the 64- and 128-row
    m-tiles when both row pitches are multiples of 16 bytes (TMA's rule)
    and there are at most MAX_TMA_EXPERTS experts; otherwise
    ``"mma_sync"``: the 16-row decode tile (already near its byte bound)
    and the shapes TMA cannot address."""
    if block_rows(m, n_experts) == 16:
        return "mma_sync"
    if k == 0 or k % 8 or n % 8 or not 1 <= n_experts <= MAX_TMA_EXPERTS:
        return "mma_sync"
    return "wgmma"


def wgmma_smem_bytes(bm: int) -> int:
    """Dynamic shared memory of one wgmma-route CTA: the ring of lhs and
    weight boxes (the bf16 output tile is staged in it), a full and an
    empty mbarrier a stage, 1 KB of alignment slack."""
    stage = (bm + WGMMA_BLOCK_COLS) * WGMMA_BLOCK_K * 2
    return WGMMA_STAGES * stage + 2 * WGMMA_STAGES * 8 + 1024


def grouped_schedule(group_sizes: Sequence[int], m: int, n: int, bm: int,
                     bn: int) -> list[tuple[int, int, int, int]]:
    """The tiles the kernel runs, in launch order: ``(expert, r0, r1, n0)``
    for each CTA that works, rows [r0, r1) of one expert's group against
    columns [n0, n0 + bn).  The grid is (ceil(m / bm) + E slots) x
    ceil(n / bn) with the slot the fast dimension, so the CTAs in flight
    run every m-tile of every expert for a few n-tiles together; slot t
    is ``gmm_tile.cuh:group_slot``: the t-th bm-row tile of the groups laid
    end to end, each group cut on its own (no tile crosses a group), and
    nothing for a slot past the last group's last tile."""
    slots = []
    off = 0
    for e, size in enumerate(group_sizes):
        size = max(int(size), 0)
        for r0 in range(off, off + size, bm):
            r1 = min(r0 + bm, off + size, m)
            if r0 < r1:
                slots.append((e, r0, r1))
        off += size
    n_slots = -(-m // bm) + len(group_sizes)
    return [(*slots[x], y * bn) for y in range(-(-n // bn)) for x in range(n_slots)
            if x < len(slots)]


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
    sizes = group_sizes.to(torch.int32).contiguous()
    route = kernel_route(m, k, n, e)
    bm = block_rows(m, e)
    if route == "wgmma":
        # the experts' tensor maps, encoded once for these weights and tile
        ptrs = _build.tensor_map_table("grouped_matmul", "ptdeco_grouped_wgmma_encode_weights",
                                       weights, n, k, bm).data_ptr()
        fn = _build.kernel_function("grouped_matmul", "ptdeco_grouped_matmul_wgmma", _ARGTYPES)
    else:
        ptrs = _build.pointer_table(weights).data_ptr()
        fn = _build.kernel_function("grouped_matmul", "ptdeco_grouped_matmul", _ARGTYPES)
    _build.launch("grouped_matmul", fn, lhs.device, lhs.data_ptr(), ptrs, sizes.data_ptr(), e,
                  out.data_ptr(), m, k, n, bm)
    grouped_matmul.launches += 1
    grouped_matmul.route_launches[route] += 1
    return out


grouped_matmul.launches = 0
# launches by route, for tests and chip_smoke.py to show which route ran
grouped_matmul.route_launches = {"wgmma": 0, "mma_sync": 0}
