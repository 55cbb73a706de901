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

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

__all__ = [
    "KERNELS",
    "BUILD_DIR",
    "aligned",
    "build_all",
    "load_library",
    "kernel_function",
    "launch",
    "pointer_table",
    "tensor_map_table",
]

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (
    pathlib.Path(__file__).resolve().parents[2] / "build" / "ptdeco_tpu_torch_kernels"
)
KERNELS = ("syrk_gram", "flash_attention_fwd", "lowrank_matmul", "grouped_matmul", "gmm_int8")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v", "-lineinfo",
)

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}
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
    fn = _fns.get((name, symbol))
    if fn is None:  # typed once: a wrapper's call pays a dict lookup only
        fn = getattr(load_library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
    return fn


def launch(what: str, fn: ctypes._CFuncPtr, device: "torch.device", *args) -> None:
    """Call kernel entry ``fn(*args, stream)`` with ``device`` current and
    its current stream, and raise if the launch failed.  When ``device`` is
    current already (the usual case) the call neither switches devices nor
    builds a stream object: a small kernel runs for less time than the
    host spends on its call."""
    import torch

    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


def aligned(t: "torch.Tensor") -> "torch.Tensor":
    """``t`` contiguous with a 16-byte aligned start, as the kernels' vector
    loads need (a contiguous view may start at any element).  A tensor that
    is so already, as a weight is, comes back without a dispatched call: a
    small kernel runs shorter than its wrapper's host work."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


_tables: "collections.OrderedDict[tuple, torch.Tensor]" = collections.OrderedDict()
_MAX_TABLES = 256


def pointer_table(tensors: "list[torch.Tensor]") -> "torch.Tensor":
    """An int64 device array of the tensors' data pointers, for kernels that
    read one matrix per expert.  Tables are cached by the pointers they
    hold, so a model's unchanged weights cost one host-to-device copy; the
    copy goes from pinned memory without a host sync."""
    import torch

    device = tensors[0].device
    key = (device.index, tuple(t.data_ptr() for t in tensors))
    with _lock:
        table = _tables.get(key)
        if table is None:
            host = torch.tensor(key[1], dtype=torch.int64).pin_memory()
            table = host.to(device, non_blocking=True)
            _tables[key] = table
            if len(_tables) > _MAX_TABLES:
                _tables.popitem(last=False)
        else:
            _tables.move_to_end(key)
        return table


_map_tables: "collections.OrderedDict[tuple, torch.Tensor]" = collections.OrderedDict()
# a CUtensorMap's bytes and the alignment a kernel reads one at
TENSOR_MAP_BYTES, TENSOR_MAP_ALIGN = 128, 64


def tensor_map_table(name: str, symbol: str, tensors: "list[torch.Tensor]",
                     *shape: int) -> "torch.Tensor":
    """A device table of TMA tensor maps, one per matrix, for kernels that
    read one matrix per expert through TMA: kernel ``name``'s C entry
    ``symbol(host pointers, count, *shape, host buffer)`` encodes them on
    the host (``shape``: the matrices' rows and columns, and whatever else
    sets the entry's boxes), and the table is copied to the device (64-byte
    aligned, as TMA reads a map there).  Tables are cached by kernel, entry,
    device, pointers and shape, so a model's unchanged weights are encoded
    once (a table's maps describe nothing but those addresses and shapes,
    so a cached table is never stale); the copy goes from pinned memory
    without a host sync."""
    import torch

    device = tensors[0].device
    ptrs = tuple(t.data_ptr() for t in tensors)
    key = (name, symbol, device.index, ptrs, *shape)
    with _lock:
        table = _map_tables.get(key)
        if table is not None:
            _map_tables.move_to_end(key)
            return table
    fn = kernel_function(name, symbol,
                         [ctypes.c_void_p] + [ctypes.c_int] * (1 + len(shape)) + [ctypes.c_void_p])
    host = torch.empty(len(ptrs) * TENSOR_MAP_BYTES, dtype=torch.uint8, pin_memory=True)
    rc = fn((ctypes.c_uint64 * len(ptrs))(*ptrs), len(ptrs), *shape, host.data_ptr())
    if rc != 0:
        raise RuntimeError(f"{name}: encoding {len(ptrs)} tensor maps failed: cudaError {rc}")
    table = host.to(device, non_blocking=True)
    if table.data_ptr() % TENSOR_MAP_ALIGN:
        raise RuntimeError(f"{name}: the tensor-map table is not {TENSOR_MAP_ALIGN}-byte aligned")
    with _lock:
        _map_tables[key] = table
        if len(_map_tables) > _MAX_TABLES:
            _map_tables.popitem(last=False)
    return table
