"""Symmetric Gram ``Yᵀ Y`` of calibration activations (SYRK).

Counterpart of ``ptdeco_tpu/ops/gram_pallas.py``.  On a CUDA tensor
``syrk_gram`` launches the hand-written Hopper kernel
(``csrc/syrk_gram.cu``); on a CPU tensor it computes the plain version.
A bf16 Gram of few 128-wide tiles over many rows (a conv site's pixels)
splits its rows over blocks (``split_rows``), each summing its rows into a
workspace slot that a second kernel adds up in split order.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["syrk_gram", "syrk_gram_plain", "should_use_syrk", "split_rows", "SYRK_MIN_DIM"]

# the TPU rule's 2 * TILE (gram_pallas.py:134): below two 256-wide tiles
# the triangle saves nothing worth a kernel
SYRK_MIN_DIM = 512


def syrk_gram_plain(y: torch.Tensor) -> torch.Tensor:
    """Full (d, d) f32 Gram (``gram_xla``)."""
    y32 = y.to(torch.float32)
    return y32.t() @ y32


def should_use_syrk(dtype: torch.dtype, d: int, is_cuda: bool) -> bool:
    """The engine's Gram dispatch rule (``should_use_syrk``): bf16
    activations with d >= 512 on the card take the kernel; every other
    site takes an f32 matmul."""
    return is_cuda and dtype == torch.bfloat16 and d >= SYRK_MIN_DIM


_TILE, _STEP = 128, 32  # the kernel's output tile edge and rows a pipeline step
# blocks a launch aims to put in flight: two on each of an H100's 132 SMs
TARGET_BLOCKS = 264
# rows a split takes at least, so that its pipeline's fill and its slot's
# write stay small beside its steps
MIN_SPLIT_ROWS = 1024


def split_rows(n: int, d: int) -> int:
    """Rows of y one block sums: n (one block a lower tile) when the tiles
    fill the card or n is short, else n split into as many slices, each a
    multiple of 32 rows, as bring the grid to about ``TARGET_BLOCKS``
    blocks."""
    t = -(-d // _TILE)
    splits = min(TARGET_BLOCKS // max(t * (t + 1) // 2, 1), n // MIN_SPLIT_ROWS)
    if splits <= 1:
        return n
    return -(-n // (splits * _STEP)) * _STEP


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def syrk_gram(y: torch.Tensor) -> torch.Tensor:
    """``Yᵀ Y`` in f32 for y of shape (N, d), bf16 or f32."""
    if y.device.type == "cpu":
        return syrk_gram_plain(y)
    if y.device.type != "cuda":
        raise ValueError(f"syrk_gram: unsupported device {y.device}")
    if y.dim() != 2 or y.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"syrk_gram: needs a 2D bf16/f32 tensor, got {tuple(y.shape)} {y.dtype}")
    y = _build.aligned(y)
    n, d = y.shape
    g = torch.empty((d, d), dtype=torch.float32, device=y.device)
    if d == 0:
        return g
    bf16 = y.dtype == torch.bfloat16
    rows = split_rows(n, d) if bf16 else n
    workspace = None
    if rows < n:
        t = -(-d // _TILE)
        workspace = torch.empty((-(-n // rows) * (t * (t + 1) // 2), _TILE, _TILE),
                                dtype=torch.float32, device=y.device)
    fn = _build.kernel_function("syrk_gram", "ptdeco_syrk_gram", _ARGTYPES)
    _build.launch("syrk_gram", fn, y.device, y.data_ptr(), g.data_ptr(), n, d, int(bf16),
                  rows, workspace.data_ptr() if workspace is not None else None)
    syrk_gram.launches += 1
    return g


syrk_gram.launches = 0
