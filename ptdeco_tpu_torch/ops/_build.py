"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface.  It is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library at first
use and loaded with ``ctypes``.  Libraries live under
``build/ptdeco_tpu_torch_kernels/`` at the repository root, named by a hash
of the sources and flags, so an edited source is rebuilt and a stale
library is never loaded.  Nothing here runs at import time: the CPU
install needs neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

__all__ = ["KERNELS", "BUILD_DIR", "aligned", "build_all", "load_library", "kernel_function"]

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (
    pathlib.Path(__file__).resolve().parents[2] / "build" / "ptdeco_tpu_torch_kernels"
)
KERNELS = ("syrk_gram", "flash_attention_fwd", "lowrank_matmul")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v", "-lineinfo",
)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, pathlib.Path, pathlib.Path]:
    out = _library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        _nvcc(), *NVCC_FLAGS, "-I", str(CSRC),
        "-o", str(tmp), str(CSRC / f"{name}.cu"),
    ]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish_build(
    name: str, proc: subprocess.Popen, tmp: pathlib.Path, out: pathlib.Path
) -> None:
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name} (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all() -> dict[str, float]:
    """Build every kernel that is not built yet, one ``nvcc`` process per
    source, all started together.  Returns wall seconds per kernel (0.0
    for one already built)."""
    started = {}
    t0 = time.perf_counter()
    for name in KERNELS:
        if not _library_path(name).exists():
            started[name] = _start_build(name)
    seconds = {name: 0.0 for name in KERNELS}
    for name, (proc, tmp, out) in started.items():
        _finish_build(name, proc, tmp, out)
        seconds[name] = time.perf_counter() - t0
    return seconds


def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _library_path(name)
            if not path.exists():
                _finish_build(name, *_start_build(name))
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def kernel_function(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """C entry point ``symbol`` of kernel ``name``, typed to return the
    CUDA error code as an int."""
    fn = getattr(load_library(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def aligned(t: "torch.Tensor") -> "torch.Tensor":
    """``t`` contiguous with a 16-byte aligned start, as the kernels' vector
    loads need (a contiguous view may start at any element)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
