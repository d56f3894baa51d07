"""Matrix Market I/O with a binary (.npz) cache (a jax-free copy of
``spmv_tpu/io/mmio.py``: the same matrices from the same files, the same
files from the same matrices, pinned by ``tests/test_torch_io.py``).

Clean-room equivalent of the reference's vendored NIST reader + high-level
loader (src/samples/mmio.h, mmio_highlevel.h): parses MatrixMarket coordinate
and array files, expands symmetric/skew/hermitian storage
(mmio_highlevel.h:439-463), handles pattern/integer/real/complex fields
(mmio_highlevel.h:380-414), and caches the parsed CSR to a binary file so
repeat runs skip the text parse (mmio_highlevel.h:531-584, cache dir
``mtx_cache/``).
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np

from ..types import CsrMatrix, INT_DTYPE

__all__ = ["read_mtx", "write_mtx", "load_matrix", "cache_path", "reads"]

_CACHE_DIR = "mtx_cache"  # same directory name as the reference

#: parses by path (``read_mtx``): the C++ parser, or the numpy text path
reads = {"native": 0, "python": 0}

#: rows a formatting pass of ``write_mtx``
_WRITE_ROWS = 1 << 16


def read_mtx(path: str, dtype=np.float64, use_native: bool = True) -> CsrMatrix:
    """Parse a MatrixMarket file into CSR (no cache).

    Coordinate files go through the C++ parser (native/spmv_native.cpp,
    ~10× faster than the numpy text path — the reference's loader is native
    C too, mmio_highlevel.h); array files and fallback use pure Python.
    """
    if use_native:
        from ..native import parse_mtx
        parsed = parse_mtx(path)
        if parsed is not None:
            reads["native"] += 1
            m, n, rows, cols, vals = parsed
            return CsrMatrix.from_coo(m, n, rows, cols, vals.astype(dtype),
                                      sum_duplicates=True)
    reads["python"] += 1
    with open(path, "r") as f:
        header = f.readline()
        m_hdr = re.match(
            r"%%MatrixMarket\s+matrix\s+(\w+)\s+(\w+)\s+(\w+)", header, re.I
        )
        if not m_hdr:
            raise ValueError(f"{path}: not a MatrixMarket matrix file")
        fmt, field, symmetry = (s.lower() for s in m_hdr.groups())
        if fmt not in ("coordinate", "array"):
            raise ValueError(f"{path}: unsupported format {fmt!r}")
        if field not in ("real", "integer", "pattern", "complex", "double"):
            raise ValueError(f"{path}: unsupported field {field!r}")
        # Skip comments / blank lines to the size line.
        line = f.readline()
        while line and (line.startswith("%") or not line.strip()):
            line = f.readline()
        sizes = line.split()
        if fmt == "coordinate":
            m, n, nnz = int(sizes[0]), int(sizes[1]), int(sizes[2])
            ncols_data = {"pattern": 2, "complex": 4}.get(field, 3)
            data = np.loadtxt(f, dtype=np.float64, ndmin=2,
                              usecols=range(ncols_data), max_rows=nnz)
            if data.size == 0:
                data = data.reshape(0, ncols_data)
            rows = data[:, 0].astype(np.int64) - 1
            cols = data[:, 1].astype(np.int64) - 1
            if field == "pattern":
                vals = np.ones(rows.size, dtype=np.float64)
            else:
                vals = data[:, 2]  # complex: real part, like a pragmatic port
        else:  # dense "array" format, column-major
            m, n = int(sizes[0]), int(sizes[1])
            per = 2 if field == "complex" else 1
            flat = np.loadtxt(f, dtype=np.float64, ndmin=2)[:, 0:per][:, 0]
            if symmetry != "general":
                # array+symmetric stores the lower triangle column by column
                rows_l, cols_l, vals_l = [], [], []
                k = 0
                for j in range(n):
                    cnt = m - j
                    r = np.arange(j, m)
                    rows_l.append(r)
                    cols_l.append(np.full(cnt, j))
                    vals_l.append(flat[k:k + cnt])
                    k += cnt
                rows = np.concatenate(rows_l)
                cols = np.concatenate(cols_l)
                vals = np.concatenate(vals_l)
            else:
                dense = flat.reshape(n, m).T
                rows, cols = np.nonzero(dense)
                vals = dense[rows, cols]

    return _finalize(m, n, rows, cols, vals, symmetry, dtype)


def _finalize(m, n, rows, cols, vals, symmetry, dtype) -> CsrMatrix:
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    if symmetry in ("symmetric", "skew-symmetric", "hermitian"):
        off = rows != cols
        sign = -1.0 if symmetry == "skew-symmetric" else 1.0
        rows, cols, vals = (
            np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]),
            np.concatenate([vals, sign * vals[off]]),
        )
    return CsrMatrix.from_coo(m, n, rows.astype(INT_DTYPE),
                              cols.astype(INT_DTYPE), vals.astype(dtype),
                              sum_duplicates=True)


def write_mtx(path: str, a: CsrMatrix) -> None:
    """Write CSR as a general real coordinate MatrixMarket file: the bytes
    ``np.savetxt(..., fmt="%d %d %.17g")`` writes, formatted a block of
    rows at a time (one ``%`` over the block, not one a row)."""
    rows = np.repeat(np.arange(a.m, dtype=np.int64), a.row_lengths) + 1
    cols = a.colidx.astype(np.int64) + 1
    vals = a.vals.astype(np.float64)
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{a.m} {a.n} {a.nnz}\n")
        for lo in range(0, a.nnz, _WRITE_ROWS):
            hi = min(lo + _WRITE_ROWS, a.nnz)
            flat = [None] * (3 * (hi - lo))
            flat[0::3] = rows[lo:hi].tolist()
            flat[1::3] = cols[lo:hi].tolist()
            flat[2::3] = vals[lo:hi].tolist()
            f.write(("%d %d %.17g\n" * (hi - lo)) % tuple(flat))


def cache_path(mtx_path: str, cache_dir: Optional[str] = None) -> str:
    """Binary cache filename — path mangled like the reference's
    ``mtx_cache/<mangled>.bin`` (mmio_highlevel.h:531-554)."""
    mangled = re.sub(r"[^A-Za-z0-9_.-]", "_", os.path.abspath(mtx_path))
    return os.path.join(cache_dir or _CACHE_DIR, mangled + ".npz")


def load_matrix(path: str, dtype=np.float64, use_cache: bool = True,
                cache_dir: Optional[str] = None) -> CsrMatrix:
    """Load a MatrixMarket file, via the binary cache when available.

    Mirrors the reference's load flow (test_spmv.c:167-186): probe cache,
    else parse and save.
    """
    cpath = cache_path(path, cache_dir)
    if use_cache and os.path.exists(cpath):
        z = np.load(cpath)
        return CsrMatrix(int(z["m"]), int(z["n"]), z["rowptr"], z["colidx"],
                         z["vals"].astype(dtype))
    a = read_mtx(path, dtype=np.float64)
    if use_cache:
        os.makedirs(os.path.dirname(cpath) or ".", exist_ok=True)
        np.savez(cpath, m=a.m, n=a.n, rowptr=a.rowptr, colidx=a.colidx,
                 vals=a.vals)
    return a.astype(dtype) if a.dtype != np.dtype(dtype) else a
