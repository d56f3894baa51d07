"""Golden-reference SpMV oracle and accuracy metrics (a copy of
``spmv_tpu/oracle.py``).

The reference validates every method against a naive CSR triple loop computed
at load time (src/samples/test_spmv.c:204-207) and reports RMSE
(test_spmv.c:138-145).  We keep exactly that contract: a trusted host-side
numpy oracle and the same RMSE definition, used by every test and by the bench
harness's accuracy column.
"""

from __future__ import annotations

import numpy as np

from .types import CsrMatrix

__all__ = ["spmv_golden", "rmse", "max_abs_err"]


def spmv_golden(a: CsrMatrix, x: np.ndarray) -> np.ndarray:
    """Naive CSR SpMV on the host (the golden oracle).

    Vectorized equivalent of the reference's golden loop
    (test_spmv.c:204-207); accumulation in float64 regardless of storage
    dtype so the oracle is strictly more accurate than any device path.
    """
    x = np.asarray(x)
    prod = a.vals.astype(np.float64) * x.astype(np.float64)[a.colidx]
    # Segment sum by row via cumsum differences — exact row-major order.
    csum = np.concatenate([[0.0], np.cumsum(prod)])
    y = csum[a.rowptr[1:].astype(np.int64)] - csum[a.rowptr[:-1].astype(np.int64)]
    return y.astype(x.dtype if x.dtype.kind == "f" else np.float64)


def rmse(y: np.ndarray, y_golden: np.ndarray) -> float:
    """Reference RMSE: sqrt(sum(((y-g)/m) * (y-g))) (test_spmv.c:138-145)."""
    y = np.asarray(y, dtype=np.float64)
    g = np.asarray(y_golden, dtype=np.float64)
    d = y - g
    return float(np.sqrt(np.sum((d / max(len(y), 1)) * d)))


def max_abs_err(y: np.ndarray, y_golden: np.ndarray) -> float:
    return float(np.max(np.abs(np.asarray(y, np.float64) - np.asarray(y_golden, np.float64)), initial=0.0))
