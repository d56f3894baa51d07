"""BCSR: 128×128 dense blocks — the MXU format
(a copy of ``spmv_tpu/formats/bcsr.py`` with ``ml_dtypes`` replaced by
:mod:`._bf16`: bf16 arrays are uint16 bit arrays here; pinned by
``tests/test_torch_formats.py``).

The reference has no blocked format (its vestigial data-types.h:30-302
declares VBCSR but nothing uses it); on TPU it is the natural systolic-array
mapping: nonempty 128×128 blocks become dense tiles and SpMV becomes a
batched (128,128)@(128,) matmul — the MXU does the FLOPs and all irregular
ops shrink by 128× (one x-block gather and one block-row segment-sum per
block instead of per nonzero), which neutralizes this device's slow
gather/scatter path (PERFNOTES.md).

Profitable when block fill (nnz / (nblocks·128²)) is high enough that the
dense-block traffic (65 KB/block f32, 32 KB bf16) beats the sparse formats;
the inspector gates on :func:`bcsr_profile`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..types import CsrMatrix, INT_DTYPE
from . import _bf16

__all__ = ["BcsrMatrix", "pack_bcsr", "bcsr_profile", "BLOCK"]

BLOCK = 128


def bcsr_profile(a: CsrMatrix):
    """(nblocks, fill) without building the blocks."""
    if a.nnz == 0:
        return 0, 0.0
    rows = np.repeat(np.arange(a.m, dtype=np.int64), a.row_lengths)
    key = (rows // BLOCK) * ((a.n // BLOCK) + 1) + \
        (a.colidx.astype(np.int64) // BLOCK)
    nblocks = len(np.unique(key))
    return nblocks, a.nnz / (nblocks * BLOCK * BLOCK)


@dataclasses.dataclass(frozen=True)
class BcsrMatrix:
    m: int
    n: int
    nnz_stored: int
    nblocks: int
    block_rows: np.ndarray   # (nblocks,) int32, sorted
    block_cols: np.ndarray   # (nblocks,) int32
    blocks: np.ndarray       # (nblocks, 128, 128) input dtype (bf16 → f32)

    @property
    def fill(self) -> float:
        return self.nnz_stored / max(self.blocks.size, 1)


def pack_bcsr(a: CsrMatrix, max_blocks: int = None,
              compress: str = "lossless") -> BcsrMatrix:
    """Dtype-preserving (f64 stays f64 — reference parity).

    ``compress="lossless"``: f32 blocks whose values all round-trip bf16
    exactly are stored bf16 — halves the dominant HBM stream (the dense
    blocks) with zero accuracy change (accumulation stays f32; the same
    trick as DIA's lossless-bf16 diagonals).  ``max_blocks`` guards the
    dense-block allocation: scattered matrices can touch one block per few
    nonzeros, turning this into a multi-GB densification.
    """
    rows = np.repeat(np.arange(a.m, dtype=np.int64), a.row_lengths)
    cols = a.colidx.astype(np.int64)
    br = rows // BLOCK
    bc = cols // BLOCK
    ncb = (a.n // BLOCK) + 1
    key = br * ncb + bc
    uniq, inv = np.unique(key, return_inverse=True)
    if max_blocks is not None and len(uniq) > max_blocks:
        raise ValueError(f"bcsr: {len(uniq)} blocks exceeds {max_blocks}")
    dtype = np.float32 if np.dtype(a.dtype).itemsize <= 4 else np.float64
    blocks = np.zeros((len(uniq), BLOCK, BLOCK), dtype=dtype)
    blocks[inv, rows % BLOCK, cols % BLOCK] = a.vals.astype(dtype)
    if compress == "lossless" and dtype == np.float32:
        from .dia import is_lossless_bf16
        if is_lossless_bf16(a.vals):
            blocks = _bf16.from_f32(blocks)
    return BcsrMatrix(
        m=a.m, n=a.n, nnz_stored=a.nnz, nblocks=len(uniq),
        block_rows=(uniq // ncb).astype(INT_DTYPE),
        block_cols=(uniq % ncb).astype(INT_DTYPE),
        blocks=blocks)
