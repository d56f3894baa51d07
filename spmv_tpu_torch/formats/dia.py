"""DIA (diagonal) format — the zero-gather fast path for banded matrices
(a copy of ``spmv_tpu/formats/dia.py`` with ``ml_dtypes`` replaced by
:mod:`._bf16`: bf16 arrays are uint16 bit arrays here; pinned by
``tests/test_torch_formats.py``).

The reference has no DIA format (its SIMD dot products handle bands like any
row, inner_spmv.h:232-286); on this TPU it is the single most profitable
specialization: ``y = Σ_d diag_d ⊙ shift(x, offset_d)`` is pure streaming —
no gather anywhere — and XLA lowers static shifts to fused slices
(PERFNOTES.md: streaming runs 25-1000× faster than gathers here).

Fill ratio (nnz / (ndiags·m)) gates profitability: padding streams zeros.
The inspector uses :func:`dia_profile` to decide.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..types import CsrMatrix, INT_DTYPE
from . import _bf16

__all__ = ["DiaMatrix", "pack_dia", "dia_profile"]


@dataclasses.dataclass(frozen=True)
class DiaMatrix:
    m: int
    n: int
    nnz_stored: int
    offsets: np.ndarray   # (ndiags,) int32, sorted; offset o holds A[i, i+o]
    data: np.ndarray      # (ndiags, m) dtype; data[d, i] = A[i, i+offsets[d]]

    @property
    def fill(self) -> float:
        return self.nnz_stored / max(self.data.size, 1)


def _offsets_of(a: CsrMatrix):
    """(rows, off_per_nnz, present_offsets) — bincount, no sort (the
    np.unique sort was the pre-deal hotspot at 36M nnz on this host)."""
    rows = np.repeat(np.arange(a.m, dtype=np.int64), a.row_lengths)
    off = a.colidx.astype(np.int64) - rows
    lo = int(off.min())
    counts = np.bincount(off - lo)          # range ≤ m+n, linear time
    uniq = np.nonzero(counts)[0] + lo
    return rows, off, uniq


def dia_profile(a: CsrMatrix):
    """(ndiags, fill) without building the format."""
    if a.nnz == 0:
        return 0, 0.0
    _, _, offs = _offsets_of(a)
    return len(offs), a.nnz / max(len(offs) * a.m, 1)


def is_lossless_bf16(vals: np.ndarray) -> bool:
    """True if every value round-trips bf16 exactly (≤8 mantissa bits).

    The reference's synthetic values are dyadic rationals k/8
    (test_spmv.c:200) precisely so arithmetic stays exact; such values are
    also exact in bf16, making 2-byte storage a free 2× on HBM traffic.
    """
    return _bf16.is_lossless(vals)


def pack_dia(a: CsrMatrix, compress: str = "lossless") -> DiaMatrix:
    """``compress``: "lossless" stores diagonals as bf16 when every value is
    exactly representable (no accuracy change — accumulation stays f32);
    "bf16" forces it (lossy); "none" keeps the input dtype.
    """
    rows, off, uniq = _offsets_of(a)
    lo = int(uniq.min())
    lut = np.zeros(int(uniq.max()) - lo + 1, dtype=np.int64)
    lut[uniq - lo] = np.arange(len(uniq))
    inv = lut[off - lo]
    # Fill row-major (CSR order → near-sequential writes), then transpose:
    # the (ndiags, m)-order scatter was cache-hostile at 36M nnz.
    data_t = np.zeros((a.m, len(uniq)), dtype=a.vals.dtype)
    data_t[rows, inv] = a.vals
    data = np.ascontiguousarray(data_t.T)
    del data_t
    if compress == "bf16" or (
            compress == "lossless"
            and np.dtype(a.dtype) == np.float32
            and is_lossless_bf16(a.vals)):
        data = _bf16.from_f32(data)
    return DiaMatrix(a.m, a.n, a.nnz, uniq.astype(INT_DTYPE), data)
