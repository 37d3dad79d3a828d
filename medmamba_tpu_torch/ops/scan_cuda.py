"""The selective-scan forward kernel K1 on Hopper: build, bind and launch.

Counterpart of ``medmamba_tpu/ops/pallas_scan.py`` (its ``_fwd_kernel_ssd``).
The kernel is ``csrc/selective_scan_fwd.cu``, compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, keyed by a hash of
the source and the flags, and loaded with ``ctypes``. The build happens on the
first launch, never at import, so the module imports on machines without a
card or a compiler.

``LAUNCHES`` counts the kernel launches made through :func:`selective_scan_fwd`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Sequence

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "selective_scan_fwd.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
N_STATE = 16
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = 0
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "selective-scan kernel cannot be built")
    return path


def build() -> str:
    """Compile the kernel (once per source hash) and return the library path.

    The compiler's resource report (``-Xptxas -v``) is kept beside the
    library as ``<name>.log``.
    """
    with open(SOURCE, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    lib_path = os.path.join(BUILD_DIR,
                            f"libselective_scan_fwd_{key.hexdigest()[:16]}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    with open(lib_path[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, lib_path)  # atomic: a concurrent build sees all or none
    return lib_path


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        fn = lib.medmamba_selective_scan_fwd
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.medmamba_cuda_error_string.argtypes = [ctypes.c_int]
        lib.medmamba_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name: str, x: torch.Tensor, device, dtypes, shape) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {x.dtype}, expected one of {dtypes}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def selective_scan_fwd(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor,
                       D: Optional[torch.Tensor] = None,
                       delta_bias: Optional[torch.Tensor] = None, *,
                       delta_softplus: bool = False,
                       reverse_dirs: Optional[Sequence[bool]] = None,
                       u_tile: int = 1, out_dtype=None,
                       valid_len: Optional[int] = None,
                       return_last_state: bool = False):
    """Launch K1 on CUDA tensors; the layouts of ``ops.selective_scan``.

    u (b, G/u_tile * dpg, L) and delta (b, G*dpg, L), B and C (b, G, 16, L),
    all float32 or all bfloat16; A (G*dpg, 16), D and delta_bias (G*dpg,)
    float32. Returns y (b, G*dpg, L) in ``out_dtype`` (float32 by default)
    and, with ``return_last_state``, the float32 state (b, G*dpg, 16) after
    each channel's last scanned step. Raises on anything the kernel does not
    take; there is no other path for a CUDA tensor.
    """
    global LAUNCHES
    if u.device.type != "cuda":
        raise ValueError(f"the CUDA selective scan needs CUDA tensors, "
                         f"got u on {u.device}")
    device = u.device
    b, d, l = delta.shape
    g = B.shape[1]
    if g < 1 or d % g or g % u_tile:
        raise ValueError(f"{d} channels, {g} groups and u_tile {u_tile} "
                         "do not divide")
    dpg = d // g
    in_t = (u.dtype,) if u.dtype in _DTYPE_CODE else tuple(_DTYPE_CODE)
    _check("u", u, device, in_t, (b, g // u_tile * dpg, l))
    _check("delta", delta, device, in_t, (b, d, l))
    _check("B", B, device, in_t, (b, g, N_STATE, l))
    _check("C", C, device, in_t, (b, g, N_STATE, l))
    _check("A", A, device, (torch.float32,), (d, N_STATE))
    for name, x in (("D", D), ("delta_bias", delta_bias)):
        if x is not None:
            _check(name, x, device, (torch.float32,), (d,))
    out_dtype = out_dtype or torch.float32
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"out_dtype {out_dtype} is not float32 or bfloat16")
    rev_mask = 0
    if reverse_dirs is not None:
        if len(reverse_dirs) != g:
            raise ValueError(f"{len(reverse_dirs)} reverse flags for {g} groups")
        rev_mask = sum(1 << k for k, f in enumerate(reverse_dirs) if f)
    if valid_len is None:
        valid_len = l
    elif not 0 <= valid_len <= l:
        raise ValueError(f"valid_len {valid_len} outside [0, {l}]")

    y = torch.empty((b, d, l), dtype=out_dtype, device=device)
    last = (torch.empty((b, d, N_STATE), dtype=torch.float32, device=device)
            if return_last_state else None)
    lib = _load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.medmamba_selective_scan_fwd(
            u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), None if D is None else D.data_ptr(),
            None if delta_bias is None else delta_bias.data_ptr(),
            y.data_ptr(), None if last is None else last.data_ptr(),
            b, g, g // u_tile, dpg, N_STATE, l, valid_len,
            int(bool(delta_softplus)), rev_mask, _DTYPE_CODE[u.dtype],
            _DTYPE_CODE[out_dtype], stream)
    if rc != 0:
        msg = lib.medmamba_cuda_error_string(rc).decode()
        raise RuntimeError(f"selective-scan kernel launch failed: {msg} ({rc})")
    LAUNCHES += 1
    return (y, last) if return_last_state else y
