"""ctypes binding of the native JPEG decoder (``jpeg_decode.cc``, libjpeg).

Counterpart of ``ptdeco_tpu/data/native_jpeg.py`` with its own copy of the
source, built as ``native_packer`` builds its library: with ``g++`` at
first use into ``build/ptdeco_tpu_torch_native/``, named by a hash of the
source, through a temporary file renamed into place.
``decode(path_or_bytes, target_min_side)`` returns an RGB uint8 HWC array
decoded with DCT-domain scaling (the smallest 1/8..8/8 scale whose short
side still covers ``target_min_side``), or None when libjpeg or ``g++``
is missing or the bytes are no decodable JPEG; callers then decode with
PIL (``datasets_image._load_image``).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import pathlib
import subprocess
import threading
from typing import Optional, Union

import numpy as np

from .native_packer import BUILD_DIR

__all__ = ["available", "decode", "rejected_decodes"]

logger = logging.getLogger(__name__)

_SRC = pathlib.Path(__file__).resolve().parent / "jpeg_decode.cc"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_unavailable = False


def _library_path() -> pathlib.Path:
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libjpeg_decode-{h}.so"


def _build(out: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = ["g++", *_FLAGS, str(_SRC), "-ljpeg", "-o", str(tmp)]
    logger.info("Building native jpeg decoder: %s", " ".join(cmd))
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _unavailable
    with _lock:
        if _lib is not None or _unavailable:
            return _lib
        out = _library_path()
        try:
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, subprocess.SubprocessError) as e:
            stderr = getattr(e, "stderr", b"")
            detail = stderr.decode(errors="replace")[-400:] if stderr else ""
            logger.warning(f"native jpeg decoder unavailable: {e} {detail}")
            _unavailable = True
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.jpeg_scaled_dims.restype = ctypes.c_int
        lib.jpeg_scaled_dims.argtypes = [u8p, ctypes.c_int64, ctypes.c_int, ip, ip]
        lib.jpeg_decode_rgb.restype = ctypes.c_int
        lib.jpeg_decode_rgb.argtypes = [u8p, ctypes.c_int64, ctypes.c_int, u8p, ctypes.c_int64,
                                        ip, ip]
        lib.jpeg_rejected_decodes.restype = ctypes.c_int64
        lib.jpeg_rejected_decodes.argtypes = []
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def rejected_decodes() -> int:
    """Decodes the native path rejected for data-corruption warnings (each
    fell back to PIL)."""
    lib = _load()
    return int(lib.jpeg_rejected_decodes()) if lib is not None else 0


def decode(src: Union[str, pathlib.Path, bytes], target_min_side: int = 0) -> Optional[np.ndarray]:
    """A JPEG as RGB uint8 (H, W, 3) at DCT-scaled resolution, or None."""
    lib = _load()
    if lib is None:
        return None
    data = src if isinstance(src, bytes) else pathlib.Path(src).read_bytes()
    buf = np.frombuffer(data, np.uint8)
    dptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    if lib.jpeg_scaled_dims(dptr, len(data), target_min_side, ctypes.byref(w), ctypes.byref(h)):
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.jpeg_decode_rgb(dptr, len(data), target_min_side,
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.nbytes,
                             ctypes.byref(w), ctypes.byref(h))
    return None if rc != 0 else out
