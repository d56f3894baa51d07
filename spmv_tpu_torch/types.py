"""Core types (a jax-free copy of ``spmv_tpu/types.py``, pinned by
``tests/test_torch_formats.py``).

Mirrors the capability surface of the reference library's public types
(``include/spmv_Defines.h:26-68`` in DevilInChina/spmv): the ``SPMV_METHODS``
enum, the ``VECTORIZED_WAY`` enum, and the CSR handle inputs — re-designed as
Python dataclasses over numpy host arrays.  Device placement happens at handle
creation (:mod:`spmv_tpu_torch.handle`), never here: preprocessing and format
inspection are host-side, exactly like the reference's handle-creation stage.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

__all__ = [
    "Method",
    "VectorizedWay",
    "CsrMatrix",
    "METHOD_NAMES",
    "VECTORIZED_NAMES",
    "INT_DTYPE",
]

# The reference fixes BASIC_INT_TYPE to int (spmv_Defines.h:10-12); we fix
# int32 — TPU-native index width (int64 indices would halve gather throughput).
INT_DTYPE = np.int32


class Method(enum.IntEnum):
    """Execution methods — parity with ``SPMV_METHODS`` (spmv_Defines.h:26-36).

    The integer values match the reference enum so CSV output and per-method
    test binaries line up 1:1.  ``AUTO`` is new: the reference README promises
    a "matrix inspect and choose best method" stage but never implements it
    (README.md:222-223); here it is a first-class method.
    """

    SERIAL = 0
    PARALLEL = 1
    BALANCED = 2
    BALANCED2 = 3
    BALANCED_YID = 4
    SELL_C_SIGMA = 5
    CSR5 = 6
    # Reference has Method_Total_Size=7 and Method_Numa=8 sentinels.
    AUTO = 9
    # TPU-native extensions (no reference counterpart):
    DIA = 10          # diagonal/banded format: shifted-stream FMAs, no gather
    BCSR = 11         # 128x128 dense blocks via MXU batched matmuls


#: Reference name strings (common.c:325-333) for CSV-schema parity.
METHOD_NAMES = {
    Method.SERIAL: "Method_Serial",
    Method.PARALLEL: "Method_Parallel",
    Method.BALANCED: "Method_Balanced",
    Method.BALANCED2: "Method_Balanced2",
    Method.BALANCED_YID: "Method_BalancedYid",
    Method.SELL_C_SIGMA: "Method_SellCSigma",
    Method.CSR5: "Method_Csr5Spmv",
    Method.AUTO: "Method_Auto",
    Method.DIA: "Method_Dia",
    Method.BCSR: "Method_Bcsr",
}


class VectorizedWay(enum.IntEnum):
    """Parity with ``VECTORIZED_WAY`` (spmv_Defines.h:18-23).

    On TPU the vector unit is not optional, so these select the *compute
    backend* instead of the SIMD ISA: ``NONE`` forces the pure-XLA lowering,
    ``VPU`` selects Pallas vector kernels (the analog of AVX2 dot products),
    ``MXU`` selects kernels that route reductions through the systolic array
    (the analog of the reference's widest-SIMD path).
    """

    NONE = 0   # pure XLA (reference: VECTOR_NONE — scalar loops)
    VPU = 1    # Pallas VPU kernels (reference: VECTOR_AVX2)
    MXU = 2    # MXU one-hot-matmul reductions (reference: VECTOR_AVX512)


VECTORIZED_NAMES = {
    VectorizedWay.NONE: "VECTOR_NONE",
    VectorizedWay.VPU: "VECTOR_AVX2",      # reference-parity CSV strings
    VectorizedWay.MXU: "VECTOR_AVX512",
}


def _as_int_array(a, name: str) -> np.ndarray:
    out = np.ascontiguousarray(a, dtype=INT_DTYPE)
    if out.ndim != 1:
        raise ValueError(f"{name} must be 1-D, got shape {out.shape}")
    return out


@dataclasses.dataclass(frozen=True)
class CsrMatrix:
    """A host-side CSR matrix — the input format of the whole framework.

    Equivalent of the raw ``(m, n, RowPtr, ColIdx, Matrix_Val)`` quintuple the
    reference passes into ``spmv_create_handle_all_in_one`` (include/spmv.h:41-52).
    Values may be float32 or float64 (reference parity; ``size`` parameter in
    spmv.h:49) or bfloat16 (TPU-native extension).
    """

    m: int
    n: int
    rowptr: np.ndarray  # (m+1,) int32
    colidx: np.ndarray  # (nnz,) int32
    vals: np.ndarray    # (nnz,) float32/float64

    def __post_init__(self):
        object.__setattr__(self, "rowptr", _as_int_array(self.rowptr, "rowptr"))
        object.__setattr__(self, "colidx", _as_int_array(self.colidx, "colidx"))
        vals = np.ascontiguousarray(self.vals)
        if vals.ndim != 1:
            raise ValueError(f"vals must be 1-D, got shape {vals.shape}")
        object.__setattr__(self, "vals", vals)
        if self.rowptr.shape[0] != self.m + 1:
            raise ValueError(
                f"rowptr length {self.rowptr.shape[0]} != m+1 = {self.m + 1}"
            )
        if self.rowptr[0] != 0:
            raise ValueError("rowptr[0] must be 0")
        nnz = int(self.rowptr[-1])
        if self.colidx.shape[0] != nnz or self.vals.shape[0] != nnz:
            raise ValueError(
                f"colidx/vals length ({self.colidx.shape[0]}/{self.vals.shape[0]}) "
                f"!= rowptr[-1] = {nnz}"
            )
        if nnz and (self.colidx.min() < 0 or self.colidx.max() >= self.n):
            raise ValueError("colidx out of range [0, n)")
        if np.any(np.diff(self.rowptr) < 0):
            raise ValueError("rowptr must be non-decreasing")

    # -- properties ---------------------------------------------------------
    @property
    def nnz(self) -> int:
        return int(self.rowptr[-1])

    @property
    def dtype(self) -> np.dtype:
        return self.vals.dtype

    @property
    def shape(self) -> tuple:
        return (self.m, self.n)

    @property
    def row_lengths(self) -> np.ndarray:
        return np.diff(self.rowptr)

    # -- constructors -------------------------------------------------------
    @staticmethod
    def from_coo(m: int, n: int, rows, cols, vals,
                 sum_duplicates: bool = True) -> "CsrMatrix":
        """Build CSR from COO triplets (rows unsorted OK; duplicates summed).

        Plays the role of the reference loader's COO→CSR conversion
        (src/samples/mmio_highlevel.h:439-463) without the symmetric-expansion
        special cases, which live in :mod:`spmv_tpu.io.mmio`.
        """
        rows = _as_int_array(rows, "rows")
        cols = _as_int_array(cols, "cols")
        vals = np.ascontiguousarray(vals)
        if rows.size and m * n <= (1 << 62):
            # single fused int64 key sorts ~3x faster than a 2-key lexsort
            # on this host (pre-deal hotspot at multi-M nnz)
            key = rows.astype(np.int64) * n + cols
            order = np.argsort(key, kind="stable")
            key = key[order]
        else:
            order = np.lexsort((cols, rows))
            key = None
        rows, cols, vals = rows[order], cols[order], vals[order]
        if sum_duplicates and rows.size:
            key_new = np.empty(rows.size, dtype=bool)
            key_new[0] = True
            if key is not None:
                key_new[1:] = key[1:] != key[:-1]
            else:
                key_new[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
            group = np.cumsum(key_new) - 1
            rows_u = rows[key_new]
            cols_u = cols[key_new]
            vals_u = np.zeros(rows_u.size, dtype=vals.dtype)
            np.add.at(vals_u, group, vals)
            rows, cols, vals = rows_u, cols_u, vals_u
        rowptr = np.zeros(m + 1, dtype=INT_DTYPE)
        np.add.at(rowptr, rows + 1, 1)
        rowptr = np.cumsum(rowptr, dtype=np.int64).astype(INT_DTYPE)
        return CsrMatrix(m, n, rowptr, cols, vals)

    @staticmethod
    def from_dense(a: np.ndarray) -> "CsrMatrix":
        a = np.asarray(a)
        rows, cols = np.nonzero(a)
        return CsrMatrix.from_coo(a.shape[0], a.shape[1], rows, cols, a[rows, cols])

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.m, self.n), dtype=self.vals.dtype)
        rows = np.repeat(np.arange(self.m), self.row_lengths)
        out[rows, self.colidx] = self.vals
        return out

    def astype(self, dtype) -> "CsrMatrix":
        return CsrMatrix(self.m, self.n, self.rowptr, self.colidx,
                         self.vals.astype(dtype))

    def transpose(self) -> "CsrMatrix":
        """CSR→CSC-as-CSR transpose (reference: common.c:207-276)."""
        rows = np.repeat(np.arange(self.m, dtype=INT_DTYPE), self.row_lengths)
        return CsrMatrix.from_coo(self.n, self.m, self.colidx, rows, self.vals,
                                  sum_duplicates=False)

    def permute_rows(self, perm: np.ndarray) -> "CsrMatrix":
        """Return the matrix with row i taken from old row perm[i]."""
        perm = _as_int_array(perm, "perm")
        lengths = self.row_lengths[perm].astype(np.int64)
        rowptr = np.zeros(self.m + 1, dtype=np.int64)
        np.cumsum(lengths, out=rowptr[1:])
        # Vectorized gather of each permuted row's nnz range: position within
        # the output minus the output row start, plus the source row start.
        total = int(rowptr[-1])
        row_of = np.repeat(np.arange(self.m), lengths)
        within = np.arange(total) - rowptr[row_of]
        take = self.rowptr[perm].astype(np.int64)[row_of] + within
        return CsrMatrix(self.m, self.n, rowptr.astype(INT_DTYPE),
                         self.colidx[take], self.vals[take])
