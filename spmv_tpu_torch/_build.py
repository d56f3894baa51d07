"""Build-on-first-use for the port's native code.

Shared libraries with plain C interfaces, loaded with ctypes:

* the host packers: ``spmv_tpu_torch/native/spmv_native.cpp`` (the port's
  copy of the JAX package's packer source), compiled with g++;
* the Hopper kernels: ``spmv_tpu_torch/csrc/*.cu``, compiled with nvcc for
  ``sm_90a``, one library per source, all compiled at once.

Outputs go into ``spmv_tpu_torch/_build/`` (gitignored), named by a hash of
the sources and the command, and are written to a temporary file first and
moved into place with ``os.replace``: parallel test workers may build at
once, and a reader never sees half a library.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from types import SimpleNamespace
from typing import List, Optional, Sequence

from .utils.profiling import launches

__all__ = ["BUILD_DIR", "check", "compile_shared", "launch", "load_kernels",
           "nvcc_path"]

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")

_lock = threading.Lock()
_kernels: Optional[SimpleNamespace] = None


def compile_shared(name: str, sources: List[str], cmd: List[str],
                   timeout: float = 600.0, deps: Sequence[str] = ()) -> str:
    """Compile ``sources`` with ``cmd + sources + ["-o", out]`` once and
    return the library's path.  The name hashes the command, the sources
    and ``deps`` (the headers they include).  The compiler's output is kept
    beside the library as ``<library>.log``.  Raises ``RuntimeError`` when
    the compiler fails."""
    h = hashlib.sha256(" ".join(cmd).encode())
    for src in list(sources) + sorted(deps):
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
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"building {name} timed out: {e}") from e
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


def load_kernels() -> SimpleNamespace:
    """Build (first use) and load the CUDA kernels: one library per
    ``csrc/*.cu``, one nvcc each, all started together.  Returns the entry
    points by name, and ``logs``, the paths of the compilers' output."""
    global _kernels
    with _lock:
        if _kernels is not None:
            return _kernels
        nvcc = nvcc_path()
        if nvcc is None:
            raise RuntimeError("nvcc not found: the CUDA kernels build on "
                               "the machine with the card")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-I", CSRC_DIR]
        deps = glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
        stems = sorted(os.path.splitext(os.path.basename(f))[0]
                       for f in glob.glob(os.path.join(CSRC_DIR, "*.cu")))
        with concurrent.futures.ThreadPoolExecutor(len(stems)) as pool:
            paths = dict(zip(stems, pool.map(lambda s: compile_shared(
                f"spmv_{s}", [os.path.join(CSRC_DIR, s + ".cu")], cmd,
                deps=deps), stems)))
        libs = {s: ctypes.CDLL(p) for s, p in paths.items()}
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        entries = {}
        for name, (stem, restype, argtypes) in {
                "spmv_dia_launch": ("dia", ctypes.c_int,
                                    [p, p, p, p, i64, i64, i64, i64, p]),
                "spmv_sell_launch": ("sell", ctypes.c_int,
                                     [p] * 13 + [i64] * 7 + [p]),
                "spmv_coo2_launch": ("coo2", ctypes.c_int,
                                     [p] * 6 + [i64] * 3 + [p]),
                "spmv_sell_cs_launch": ("sell_cs", ctypes.c_int,
                                        [p] * 6 + [i64, p]),
                "spmv_csr_split_launch": ("csr_split", ctypes.c_int,
                                          [p] * 9 + [i64, p]),
                "spmv_probe_tile_stream": ("probes", ctypes.c_int,
                                           [p] * 9 + [i64] * 5 + [p]),
                "spmv_probe_tile_body": ("probes", ctypes.c_int,
                                         [p] * 16 + [i64] * 9 + [p]),
                "spmv_probe_window_gather": ("probes", ctypes.c_int,
                                             [p] * 12 + [i64] * 4 + [p]),
                "spmv_probe_tiny": ("probes", ctypes.c_int, [p] * 3),
                "spmv_probe_tiny_chain": ("probes", ctypes.c_int,
                                          [p] * 3 + [i64] * 2 + [p]),
                "spmv_probe_fma_err": ("probes", ctypes.c_int,
                                       [p] * 4 + [i64, p]),
                "spmv_cuda_error_string": ("errors", ctypes.c_char_p,
                                           [ctypes.c_int])}.items():
            fn = getattr(libs[stem], name)
            fn.restype, fn.argtypes = restype, argtypes
            entries[name] = fn
        _kernels = SimpleNamespace(
            **entries, libs=libs,
            logs=[path + ".log" for path in paths.values()])
        return _kernels


def check(lib: SimpleNamespace, err: int, what: str) -> None:
    """Raise when a launch entry returned a CUDA error code."""
    if err:
        msg = lib.spmv_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def launch(kernel: str, entry: str, *args, n: int = 1) -> None:
    """Every kernel launch: the entry point ``entry`` called with ``args``
    (built on first use), a CUDA error raised, ``n`` launches of
    ``kernel`` counted in ``profiling.launches``."""
    lib = _kernels if _kernels is not None else load_kernels()
    err = getattr(lib, entry)(*args)
    if err:
        check(lib, err, kernel)
    launches[kernel] += n
