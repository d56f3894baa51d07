"""Row-split CSR with explicit columns: the heavy rows of the row-split
hybrid as the H100 reads them (K13, ``ops/csr_split.py``,
``csrc/csr_split.cu``).

The heavy part of the hybrid (``sell8d.prepare_hybrid``: the rows at least
the split's length, compact and sorted longest first) rides SELL-8W tiles
on the TPU, whose 1024-column windows keep x in VMEM.  A permuted
scale-free graph spreads each heavy row over many windows, so most slots
of that stream are padding (7.44 slots a nonzero on Graph500 SCALE 19).
The card keeps x whole in its L2, so this layout stores the rows as CSR,
each nonzero once, and needs no windows:

* ``cols`` (int32) and ``vals`` (f32) hold the nonzeros in CSR order, rows
  in the order given (the hybrid's is longest first);
* each row is cut into ``ceil(L / piece)`` pieces of near-equal length, at
  most :data:`PIECE` nonzeros each (the reference's ``Balanced2``
  intra-row split), so that no warp of the kernel takes a hub row alone;
  a row with no nonzero keeps one empty piece, so that every row is
  written;
* ``piece_ptr`` gives each piece's first nonzero (the pieces tile the
  planes in order), ``piece_row`` its row and ``row_piece`` each row's
  first piece; the kernel gives each piece a warp.

``ops.use_card_layout`` is the rule that picks this layout over SELL-8W
(``ops.card_layout``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..types import CsrMatrix

__all__ = ["PIECE", "CsrSplit", "pack_csr_split", "piece_bounds",
           "layout_bytes"]

#: the most nonzeros a piece holds (P): the fastest of 256 to 16,384 on
#: Graph500 SCALE 19's heavy rows on the H100 (PERF.md §6)
PIECE = 4096


@dataclasses.dataclass(frozen=True)
class CsrSplit:
    """One row-split CSR pack with explicit columns (see the module)."""

    m: int
    n: int
    nnz: int
    piece: int                 # the most nonzeros a piece holds
    piece_ptr: np.ndarray      # (npieces + 1,) int32: each piece's 1st nnz
    piece_row: np.ndarray      # (npieces,) int32
    row_piece: np.ndarray      # (m + 1,) int32: each row's first piece
    cols: np.ndarray           # (nnz,) int32
    vals: np.ndarray           # (nnz,) float32

    @property
    def npieces(self) -> int:
        return len(self.piece_row)

    @property
    def split_rows(self) -> int:
        """Rows cut into more than one piece."""
        return int(np.count_nonzero(np.diff(self.row_piece) > 1))


def _pieces_a_row(lens: np.ndarray, piece: int) -> np.ndarray:
    return np.maximum(-(-lens // piece), 1)


def piece_bounds(row_lengths, piece: int = PIECE):
    """(piece_ptr, piece_row, row_piece) of rows of these lengths, int64:
    a row of L nonzeros in ``ceil(L / piece)`` pieces (one where L is 0),
    the j-th of k ending at ``floor((j + 1) L / k)`` within the row."""
    lens = np.asarray(row_lengths, dtype=np.int64)
    k = _pieces_a_row(lens, piece)
    row_piece = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(k, out=row_piece[1:])
    piece_row = np.repeat(np.arange(len(lens), dtype=np.int64), k)
    j = np.arange(len(piece_row), dtype=np.int64) - row_piece[piece_row]
    rowptr = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=rowptr[1:])
    piece_ptr = np.zeros(len(piece_row) + 1, dtype=np.int64)
    piece_ptr[1:] = (rowptr[piece_row]
                     + (j + 1) * lens[piece_row] // k[piece_row])
    return piece_ptr, piece_row, row_piece


def layout_bytes(row_lengths, piece: int = PIECE) -> int:
    """The bytes of the layout :func:`pack_csr_split` gives rows of these
    lengths (the two planes, the piece and row tables), from the lengths
    alone."""
    lens = np.asarray(row_lengths, dtype=np.int64)
    npieces = int(_pieces_a_row(lens, piece).sum())
    return int(lens.sum()) * 8 + npieces * 8 + 4 + (len(lens) + 1) * 4


def pack_csr_split(a: CsrMatrix, piece: int = PIECE) -> CsrSplit:
    """Pack every nonzero of ``a`` (its f32 values) in the layout, rows in
    their order, pieces of at most ``piece`` nonzeros."""
    if piece < 1:
        raise ValueError(f"csr_split: a piece of {piece} nonzeros")
    if a.nnz + a.m >= 2 ** 31 or a.n >= 2 ** 31:
        # nonzeros and pieces (at most nnz + m) are counted in int32
        raise ValueError("csr_split: the layout's int32 offsets overflow")
    lens = np.asarray(a.row_lengths, dtype=np.int64)
    piece_ptr, piece_row, row_piece = piece_bounds(lens, piece)
    return CsrSplit(m=a.m, n=a.n, nnz=int(a.nnz), piece=int(piece),
                    piece_ptr=piece_ptr.astype(np.int32),
                    piece_row=piece_row.astype(np.int32),
                    row_piece=row_piece.astype(np.int32),
                    cols=np.ascontiguousarray(a.colidx, dtype=np.int32),
                    vals=np.ascontiguousarray(a.vals, dtype=np.float32))
