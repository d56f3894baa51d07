"""Build-on-first-use for the port's native code.

Two shared libraries, both plain C interfaces loaded with ctypes:

* the host packers: the JAX package's one C++ source,
  ``spmv_tpu/native/spmv_native.cpp``, compiled by file path with g++ (so
  both packages pack with the same code);
* the Hopper kernels: ``spmv_tpu_torch/csrc/*.cu``, compiled with nvcc for
  ``sm_90a``.

Outputs go into ``spmv_tpu_torch/_build/`` (gitignored), named by a hash of
the sources and the command, and are written to a temporary file first and
moved into place with ``os.replace``: parallel test workers may build at
once, and a reader never sees half a library.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional

__all__ = ["BUILD_DIR", "check", "compile_shared", "load_kernels", "nvcc_path"]

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")

_lock = threading.Lock()
_kernels: Optional[ctypes.CDLL] = None


def compile_shared(name: str, sources: List[str], cmd: List[str],
                   timeout: float = 600.0) -> str:
    """Compile ``sources`` with ``cmd + sources + ["-o", out]`` once and
    return the library's path.  The compiler's output is kept beside the
    library as ``<library>.log``.  Raises ``RuntimeError`` when the
    compiler fails."""
    h = hashlib.sha256(" ".join(cmd).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        res = subprocess.run(cmd + sources + ["-o", tmp],
                             capture_output=True, text=True,
                             timeout=timeout)
        if res.returncode != 0:
            raise RuntimeError(f"building {name} failed:\n{res.stderr}")
        with open(tmp + ".log", "w") as f:
            f.write(res.stdout + res.stderr)
        os.replace(tmp + ".log", out + ".log")
        os.replace(tmp, out)
    finally:
        for p in (tmp, tmp + ".log"):
            if os.path.exists(p):
                os.remove(p)
    return out


def nvcc_path() -> Optional[str]:
    """nvcc on PATH, else the toolkit's default location, else None."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.path.exists(default) else None


def load_kernels() -> ctypes.CDLL:
    """Build (first use) and load the CUDA kernels library."""
    global _kernels
    with _lock:
        if _kernels is not None:
            return _kernels
        nvcc = nvcc_path()
        if nvcc is None:
            raise RuntimeError("nvcc not found: the CUDA kernels build on "
                               "the machine with the card")
        sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
        path = compile_shared(
            "spmv_kernels", sources,
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-I", CSRC_DIR])
        lib = ctypes.CDLL(path)
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.spmv_dia_launch.restype = ctypes.c_int
        lib.spmv_dia_launch.argtypes = [p, p, p, p, i64, i64, i64, i64, p]
        lib.spmv_sell_launch.restype = ctypes.c_int
        lib.spmv_sell_launch.argtypes = [p] * 9 + [i64] * 8 + [p]
        lib.spmv_cuda_error_string.restype = ctypes.c_char_p
        lib.spmv_cuda_error_string.argtypes = [ctypes.c_int]
        _kernels = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch entry returned a CUDA error code."""
    if err:
        msg = lib.spmv_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
