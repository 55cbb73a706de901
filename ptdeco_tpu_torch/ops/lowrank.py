"""Fused low-rank forward ``y = (x @ K1) @ K2 + b``.

Counterpart of ``ptdeco_tpu/ops/lowrank_pallas.py``.  ``k1`` is (d_in, r)
and ``k2`` is (r, d_out), the JAX package's layout; a factor pair's
``nn.Linear`` weights are their transposes, which the kernel reads as they
lie.  On a CUDA tensor ``lowrank_matmul`` launches the hand-written Hopper
kernel (``csrc/lowrank_matmul.cu``) for every shape: the TPU version's
small-shape gate (n < 256, d_out < 512, r < 128 or > 12 MB fall to XLA) was
measured on a TPU and is not carried over.  On a CPU tensor the plain
version runs.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

__all__ = ["lowrank_matmul", "lowrank_matmul_plain", "MAX_SHARED_BYTES"]

# shared memory one block may use on Hopper (227 KB)
MAX_SHARED_BYTES = 232448


def lowrank_matmul_plain(
    x: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor, bias: Optional[torch.Tensor]
) -> torch.Tensor:
    """``lowrank_xla``: f32 products, hidden rounded to x's dtype."""
    h = (x.to(torch.float32) @ k1.to(torch.float32)).to(x.dtype)
    y = h.to(torch.float32) @ k2.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def lowrank_matmul(
    x: torch.Tensor,
    k1: torch.Tensor,
    k2: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused ``(x @ K1) @ K2 + b`` for x of shape (..., d_in)."""
    lead, d_in = x.shape[:-1], x.shape[-1]
    r, d_out = k1.shape[1], k2.shape[1]
    x2 = x.reshape(-1, d_in)
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
    if any(t.dtype != torch.bfloat16 or t.device != x.device for t in tensors):
        raise ValueError("lowrank_matmul: the kernel takes bf16 tensors on one device")
    if r < 1:
        raise ValueError(f"lowrank_matmul: rank {r} < 1")
    smem = _build.kernel_function(
        "lowrank_matmul", "ptdeco_lowrank_smem_bytes", [ctypes.c_int]
    )(r)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"lowrank_matmul: rank {r} needs {smem} bytes of shared memory "
            f"per block, over the {MAX_SHARED_BYTES} a block may use"
        )
    x2 = _build.aligned(x2)
    w1 = _build.aligned(k1.t())  # (r, d_in): a no-op for a Linear weight's view
    w2 = _build.aligned(k2.t())  # (d_out, r)
    b = _build.aligned(bias) if bias is not None else None
    n = x2.shape[0]
    out = torch.empty((n, d_out), dtype=x.dtype, device=x.device)
    if n == 0 or d_out == 0:
        return out.reshape(*lead, d_out)
    fn = _build.kernel_function("lowrank_matmul", "ptdeco_lowrank_matmul", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x2.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                b.data_ptr() if b is not None else None, out.data_ptr(),
                n, d_in, r, d_out, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lowrank_matmul kernel launch failed: cudaError {rc}")
    lowrank_matmul.launches += 1
    return out.reshape(*lead, d_out)


lowrank_matmul.launches = 0
