"""Build and load the port's hand-written CUDA kernels.

Each source in ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, keyed by a hash of the source, the
local headers it includes and the flags, and loaded with ``ctypes``. A
build happens on a kernel's first launch (or when :func:`build` is called),
never at import, so the modules import on machines without a card or a
compiler.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from typing import Callable, Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "port's CUDA kernels cannot be built")
    return path


_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_files(source: str) -> List[str]:
    """``source`` (a file name in ``csrc/``) and the ``csrc/`` headers it
    includes with ``#include "..."``, directly or through another, in the
    order they are first reached."""
    files = [source]
    for name in files:
        with open(os.path.join(CSRC, name)) as f:
            for inc in _LOCAL_INCLUDE.findall(f.read()):
                if inc not in files:
                    files.append(inc)
    return files


def library_path(source: str) -> str:
    """Where the library built from ``source`` (a file name in ``csrc/``)
    lives; the compiler's resource report (``-Xptxas -v``) sits beside it
    as ``<name>.log``. The name changes with the source, any local header
    it includes and the flags."""
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in source_files(source):
        with open(os.path.join(CSRC, name), "rb") as f:
            key.update(name.encode() + b"\0" + f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{key.hexdigest()[:16]}.so")


def build(*sources: str) -> List[str]:
    """Compile the sources that are not built yet, one ``nvcc`` for each,
    all started together; return the library paths in the given order.
    Raises with the compiler's output if any build fails."""
    paths = [library_path(s) for s in sources]
    jobs = []
    for src, path in zip(sources, paths):
        if os.path.exists(path):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((src, path, tmp, proc))
    failures = []
    for src, path, tmp, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc {src} failed ({proc.returncode}):\n"
                            f"{out}\n{err}")
            continue
        with open(path[:-3] + ".log", "w") as f:
            f.write(out + err)
        os.replace(tmp, path)  # atomic: a concurrent build sees all or none
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load(source: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library built from ``source``, built on first use; ``declare``
    sets the argument and result types of its functions once."""
    lib = _libs.get(source)
    if lib is None:
        lib = ctypes.CDLL(build(source)[0])
        lib.medmamba_cuda_error_string.argtypes = [ctypes.c_int]
        lib.medmamba_cuda_error_string.restype = ctypes.c_char_p
        declare(lib)
        _libs[source] = lib
    return lib


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a kernel's C entry point reported an error."""
    if rc != 0:
        msg = lib.medmamba_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")
