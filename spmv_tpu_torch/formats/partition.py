"""Host-side partition planning (the port of ``balanced_row_splitter`` from
``spmv_tpu/formats/partition.py``): nnz-quantile row blocks for the mesh's
row-sharded plans."""

from __future__ import annotations

import numpy as np

from ..types import INT_DTYPE

__all__ = ["balanced_row_splitter"]


def balanced_row_splitter(rowptr: np.ndarray, nblocks: int) -> np.ndarray:
    """nnz-quantile row boundaries: block b owns rows [s[b], s[b+1]).

    Semantics of the reference's ``init_csrSplitter_balanced``
    (parallel_balanced_spmv.c:39-58): stride ceil(nnz/B), binary-search the
    row boundary per block, then enforce monotonicity.  Whole rows only —
    a mega-row larger than the stride lands in one block.
    """
    m = len(rowptr) - 1
    nnz = int(rowptr[-1])
    if nblocks <= 0:
        raise ValueError("nblocks must be positive")
    stride = -(-max(nnz, 1) // nblocks)
    targets = np.arange(1, nblocks, dtype=np.int64) * stride
    cuts = np.searchsorted(rowptr, targets, side="left").astype(np.int64)
    splitter = np.concatenate([[0], cuts, [m]])
    # monotonicity fix (reference parallel_balanced_spmv.c:51-55)
    np.maximum.accumulate(splitter, out=splitter)
    return np.minimum(splitter, m).astype(INT_DTYPE)
