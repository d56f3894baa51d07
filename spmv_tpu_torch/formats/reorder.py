"""Row reordering for the slice's plans — the two functions of
``spmv_tpu/formats/reorder.py`` that the AUTO path calls
(``sell8d.prepare_hybrid`` and the handle's rows-only length sort), copied
unchanged.  The symmetric reorders (``reorder=``) are not ported yet.
"""

from __future__ import annotations

import numpy as np

from ..types import CsrMatrix, INT_DTYPE

__all__ = ["length_order", "reorder_rows"]


def reorder_rows(a: CsrMatrix, perm: np.ndarray) -> CsrMatrix:
    """Row-only permutation (y' = y[perm]; x unchanged)."""
    return a.permute_rows(perm.astype(INT_DTYPE))


def length_order(a: CsrMatrix) -> np.ndarray:
    """Rows sorted by descending nnz — the reference's SELL σ-sort
    (sell_C_Sigma_spmv.c:222) taken global.

    On heavy-tailed (power-law) matrices the natural order packs terribly
    in SELL-8W: a mega-row's nonzeros all share one lane, forcing depth
    ~len/8 nearly-empty tiles per window.  Length-sorting clusters heavy
    rows into the same 128-row slices, so their lane counts balance and
    tiles fill.  Stable sort keeps equal-length rows in natural order
    (column locality of the light tail is preserved up to slice
    granularity).
    """
    return np.argsort(-a.row_lengths.astype(np.int64),
                      kind="stable").astype(np.int64)
