"""ctypes bindings for the native C++ IO library (native/medmamba_io.cpp).

A copy of ``medmamba_tpu/data/native.py`` for the PyTorch port; both load the
same library from the repository's ``native/`` directory.

Builds on demand with ``make`` on first use; falls back to None (callers
use the pure-Python path) when a toolchain isn't available. A process tries
the build once: where it fails, each later call returns None at once
instead of running ``make`` again, which cost about 250 ms of host time a
batch.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SO_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libmedmamba_io.so"))

_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    # Always run make (a no-op when the .so is fresh): a stale prebuilt
    # library from an older checkout would otherwise load but miss newer
    # symbols (dlopen caches handles, so rebuilding after CDLL is too late).
    try:
        subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR)],
                       check=True, capture_output=True, timeout=120)
    except Exception:
        if not os.path.exists(_SO_PATH):
            return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None
    if not hasattr(lib, "batch_decode_resize_ex"):  # pragma: no cover
        return None  # stale binary that survived the rebuild: PIL fallback
    lib.decode_resize.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_uint8)]
    lib.decode_resize.restype = ctypes.c_int
    lib.batch_decode_resize.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int]
    lib.batch_decode_resize.restype = ctypes.c_int
    lib.batch_decode_resize_ex.argtypes = \
        lib.batch_decode_resize.argtypes + [ctypes.c_int]
    lib.batch_decode_resize_ex.restype = ctypes.c_int
    lib.gather_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)]
    lib.gather_u8.restype = None
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def batch_decode_resize(paths: List[str], size: int, n_threads: int = 0,
                        fast: Optional[bool] = None) -> Optional[np.ndarray]:
    """Decode+resize a list of image files to (N, size, size, 3) uint8.

    ``fast`` enables DCT-domain scaled JPEG decode (decode at the smallest
    libjpeg N/8 scale that still covers ``size``, then the same PIL-parity
    triangle resize): ~2x faster on large JPEGs, pixel values deviate
    slightly from the full-decode path (the standard DALI / tf.image
    reduced-scale trick). Default: the MEDMAMBA_FAST_DECODE env var (off ->
    bit-exact PIL-parity decode).

    Returns None if the native library is unavailable or any image failed
    (caller falls back to PIL).
    """
    lib = _load()
    if lib is None:
        return None
    if fast is None:
        fast = os.environ.get("MEDMAMBA_FAST_DECODE", "0") == "1"
    n = len(paths)
    out = np.empty((n, size, size, 3), np.uint8)
    status = np.zeros((n,), np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    fails = lib.batch_decode_resize_ex(
        arr, n, size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n_threads,
        1 if fast else 0)
    if fails:
        return None
    return out


def gather_u8(src: np.ndarray, idx: np.ndarray) -> Optional[np.ndarray]:
    """out[i] = src[idx[i]] for a C-contiguous uint8 array, done natively."""
    lib = _load()
    if lib is None or not src.flags.c_contiguous or src.dtype != np.uint8:
        return None
    idx = np.ascontiguousarray(idx, np.int64)
    row_bytes = int(np.prod(src.shape[1:]))
    out = np.empty((len(idx),) + src.shape[1:], np.uint8)
    lib.gather_u8(src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                  idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                  len(idx), row_bytes,
                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out
