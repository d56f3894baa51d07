"""SELL-32-σ with explicit columns: the light rows of the row-split hybrid
as the H100 reads them (K12, ``ops/sell_cs.py``, ``csrc/sell_cs.cu``).

The light part of the hybrid (``sell8d.prepare_hybrid``: the rows shorter
than the heavy split, in natural order) rides SELL-8D slot bundles on the
TPU, whose 1024-column windows keep x in VMEM.  A permuted scale-free
graph spreads each short row over many bundles, so most slots of that
stream are padding.  The card needs no windows where x fits its L2, so
this layout stores each nonzero's column beside its value:

* the rows are sorted by length, longest first (σ is the whole part; ties
  keep row order), and cut into slices of :data:`SLICE` rows, one warp a
  slice, one thread a row; rows with no nonzero (the heavy rows, empty
  rows) sort last and fill slices of length 0;
* a slice stores its rows column-major: slot (j, lane) holds the j-th
  nonzero of the slice's lane-th row, an int32 column and an f32 value in
  two planes; a row shorter than its slice's longest gets padding slots
  (column 0, value 0);
* ``slice_ptr`` gives each slice's first slot (a slice of length L holds
  32 · L slots), ``rows`` each lane's output row (-1 past m), so that one
  pass writes every one of the m output rows.

``ops.use_card_layout`` is the rule that picks this layout over SELL-8D
(``ops.card_layout``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..types import CsrMatrix

__all__ = ["SLICE", "SellCS", "pack_sell_cs", "layout_bytes"]

#: rows a slice: one warp, one thread a row
SLICE = 32
#: bytes a slot (int32 column, f32 value) and a lane's output row (int32)
_SLOT_BYTES = 8
_ROW_BYTES = 4


@dataclasses.dataclass(frozen=True)
class SellCS:
    """One SELL-32-σ pack with explicit columns (see the module)."""

    m: int
    n: int
    nnz: int                   # stored nonzeros, padding not counted
    slice_ptr: np.ndarray      # (nslices + 1,) int32: each slice's 1st slot
    rows: np.ndarray           # (nslices * 32,) int32: output row, -1 past m
    cols: np.ndarray           # (nslots,) int32
    vals: np.ndarray           # (nslots,) float32

    @property
    def nslices(self) -> int:
        return len(self.slice_ptr) - 1

    @property
    def nslots(self) -> int:
        return int(self.slice_ptr[-1])


def _sorted_lengths(row_lengths) -> tuple:
    """(order, lengths in that order padded to whole slices, the slice
    lengths): rows longest first, ties in row order."""
    lens = np.asarray(row_lengths, dtype=np.int64)
    order = np.argsort(-lens, kind="stable")
    nsl = -(-len(lens) // SLICE)
    padded = np.zeros(nsl * SLICE, dtype=np.int64)
    padded[:len(lens)] = lens[order]
    return order, padded, padded.reshape(nsl, SLICE).max(axis=1,
                                                         initial=0)


def layout_bytes(row_lengths) -> int:
    """The bytes of the layout :func:`pack_sell_cs` gives rows of these
    lengths (slots, output rows, slice offsets), from the lengths alone."""
    _o, padded, slen = _sorted_lengths(row_lengths)
    return (int(slen.sum()) * SLICE * _SLOT_BYTES + len(padded) * _ROW_BYTES
            + (len(slen) + 1) * 4)


def pack_sell_cs(a: CsrMatrix) -> SellCS:
    """Pack every nonzero of ``a`` (its f32 values) in the layout: the
    slot of the k-th nonzero of the row at sorted position i is
    ``slice_ptr[i // 32] + 32 k + i % 32``, in the row's CSR order."""
    order, padded, slen = _sorted_lengths(a.row_lengths)
    slice_ptr = np.zeros(len(slen) + 1, dtype=np.int64)
    np.cumsum(slen * SLICE, out=slice_ptr[1:])
    if slice_ptr[-1] >= 2 ** 31 or max(a.m, a.n) >= 2 ** 31:
        raise ValueError("sell_cs: the layout's int32 offsets overflow")
    lens = np.asarray(a.row_lengths, dtype=np.int64)
    rank = np.empty(a.m, dtype=np.int64)
    rank[order] = np.arange(a.m)
    row_of = np.repeat(np.arange(a.m, dtype=np.int64), lens)
    k = (np.arange(a.nnz, dtype=np.int64)
         - np.asarray(a.rowptr, dtype=np.int64)[row_of])
    i = rank[row_of]
    del row_of
    pos = slice_ptr[i >> 5] + (k << 5) + (i & (SLICE - 1))
    del i, k
    cols = np.zeros(int(slice_ptr[-1]), dtype=np.int32)
    vals = np.zeros(int(slice_ptr[-1]), dtype=np.float32)
    cols[pos] = a.colidx
    vals[pos] = np.asarray(a.vals, dtype=np.float32)
    rows = np.full(len(padded), -1, dtype=np.int32)
    rows[:a.m] = order
    return SellCS(m=a.m, n=a.n, nnz=int(a.nnz),
                  slice_ptr=slice_ptr.astype(np.int32), rows=rows,
                  cols=cols, vals=vals)
