"""ctypes binding of the native greedy token packer (``packer.cc``).

Counterpart of ``ptdeco_tpu/data/native_packer.py`` with its own copy of
the source.  The library is built with ``g++`` at first use into
``build/ptdeco_tpu_torch_native/`` at the repository root, named by a hash
of the source, through a temporary file renamed into place, so a process
never loads a half-written or stale library.  A failed build is
remembered; callers fall back to their Python loop.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import pathlib
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

__all__ = ["pack_greedy", "shuffle_indices"]

logger = logging.getLogger(__name__)

_SRC = pathlib.Path(__file__).resolve().parent / "packer.cc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "ptdeco_tpu_torch_native"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_unavailable = False


def _library_path() -> pathlib.Path:
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libpacker-{h}.so"


def _build(out: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    logger.info("Building native packer: %s", " ".join(cmd))
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> ctypes.CDLL:
    global _lib, _unavailable
    with _lock:
        if _lib is not None:
            return _lib
        if _unavailable:
            raise RuntimeError("native packer unavailable (build failed)")
        out = _library_path()
        try:
            if not out.exists():
                _build(out)
        except (OSError, subprocess.SubprocessError) as e:
            _unavailable = True
            stderr = getattr(e, "stderr", b"")
            detail = stderr.decode(errors="replace")[-400:] if stderr else ""
            logger.warning(f"native packer build failed: {e} {detail}")
            raise
        lib = ctypes.CDLL(str(out))
        lib.pack_greedy.restype = ctypes.c_int64
        lib.pack_greedy.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
        ]
        lib.shuffle_indices.restype = None
        lib.shuffle_indices.argtypes = [ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                                        ctypes.c_uint64]
        _lib = lib
        return lib


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def pack_greedy(
    token_lists: Sequence[Sequence[int]], sep: Sequence[int], max_seqlen: int
) -> np.ndarray:
    """Pack documents into (n_rows, max_seqlen) int32 rows (v2 semantics)."""
    lib = _load()
    lengths = np.fromiter((len(t) for t in token_lists), np.int64, len(token_lists))
    offsets = np.zeros(len(token_lists) + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    flat = np.empty(int(offsets[-1]), np.int32)
    for i, t in enumerate(token_lists):
        flat[offsets[i] : offsets[i + 1]] = np.asarray(t, np.int32)
    sep_arr = np.asarray(list(sep), np.int32)
    total = int(offsets[-1]) + len(token_lists) * max(len(sep_arr), 1)
    max_rows = max(total // max_seqlen + 1, 1)
    out = np.empty((max_rows, max_seqlen), np.int32)
    n_rows = lib.pack_greedy(
        _i32p(flat), _i64p(offsets), len(token_lists), _i32p(sep_arr), len(sep_arr),
        max_seqlen, _i32p(out), max_rows,
    )
    return out[:n_rows].copy()


def shuffle_indices(n: int, seed: int) -> np.ndarray:
    """A permutation of ``range(n)`` (int64), the same for a seed as the JAX
    package's ``native_packer.shuffle_indices``."""
    lib = _load()
    idx = np.arange(n, dtype=np.int64)
    lib.shuffle_indices(_i64p(idx), n, seed)
    return idx
