"""Row-split CSR with explicit columns: the kernel ``csrc/csr_split.cu``
(K13, ``csr_split``) and its plain version.

K13 replaces no TPU kernel.  It runs the heavy part of an f32 row-split
hybrid on the card in place of the SELL-8W row stream (K1 row, which
replaces ``spmv_tpu/ops/pallas_sell.py::_kernel_v2`` in row mode) where
``ops.use_card_layout`` picks it: there the row stream is
mostly padding, which the TPU's x windows forced and the card's L2 does
not need.  The layout is ``formats/csr_split.py``'s; the kernel is bound
by its two planes (8 B a nonzero) and the x gathers, which hit the L2
where x fits it (see the source).

A piece's 32 lanes each sum their nonzeros (lane l: the piece's nonzeros
l, l + 32, ...) in order, one FMA a nonzero; a butterfly of f32 adds (xor
16, 8, 4, 2, 1) gives the piece's sum; a row of several pieces adds its
piece sums in piece order, from 0.  So a row's result is fixed and
repeats bit for bit.  The plain version adds the same terms in the same
order; it rounds each step's product and sum once, in f64, then to f32,
which differs from the FMA only where that double rounding does.  The tickets that pick a row's last piece are the only
state that launches share: ``ops.tickets`` keeps a set for each CUDA
stream.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _build
from ..formats.csr_split import CsrSplit
from ..utils.profiling import dev_put
from . import kernel, tickets

__all__ = ["SplitStream", "prepare_split", "split_spmv", "split_plain",
           "split_decode", "describe", "KERNEL"]

#: the kernel's name in ``profiling.launches``; its span is
#: ``spmv.kernel.csr_split``
KERNEL = "csr_split"
#: lanes a piece
_WARP = 32


@dataclasses.dataclass(frozen=True)
class SplitStream:
    """Device arrays of one :class:`CsrSplit` pack."""

    m: int
    n: int
    nnz: int
    piece: int                    # the most nonzeros a piece holds
    split_rows: int               # rows of more than one piece
    piece_ptr: torch.Tensor       # (npieces + 1,) int32
    piece_row: torch.Tensor       # (npieces,) int32
    row_piece: torch.Tensor       # (m + 1,) int32
    cols: torch.Tensor            # (nnz,) int32
    vals: torch.Tensor            # (nnz,) float32
    #: the kernel's per-row ticket counters, :attr:`ntickets` int32 zeros
    #: that each launch leaves 0, one set a CUDA stream: (device index,
    #: cuda_stream) → tensor, made by ``ops.tickets`` (a
    #: ``dataclasses.replace`` copy starts with none)
    tickets_by_stream: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)
    # the kernel's name and the type of x and y (class attributes)
    kernel = KERNEL
    dtype = torch.float32

    @property
    def npieces(self) -> int:
        return self.piece_row.numel()

    @property
    def ntickets(self) -> int:
        return max(self.m, 1)

    @property
    def device(self) -> torch.device:
        return self.vals.device


def prepare_split(p: CsrSplit, device) -> SplitStream:
    """Place a pack on ``device``."""
    return SplitStream(
        m=int(p.m), n=int(p.n), nnz=int(p.nnz), piece=int(p.piece),
        split_rows=p.split_rows,
        piece_ptr=dev_put(np.asarray(p.piece_ptr, dtype=np.int32), device),
        piece_row=dev_put(np.asarray(p.piece_row, dtype=np.int32), device),
        row_piece=dev_put(np.asarray(p.row_piece, dtype=np.int32), device),
        cols=dev_put(np.asarray(p.cols, dtype=np.int32), device),
        vals=dev_put(np.asarray(p.vals, dtype=np.float32), device))


def split_plain(st: SplitStream, x: torch.Tensor) -> torch.Tensor:
    """The plain version, (m,) f32: each lane's nonzeros added in order
    (``acc + v · x[c]`` in f64, rounded to f32 each step), each piece's
    lanes by the kernel's butterfly, each row's pieces in piece order from
    0 where it has several."""
    x = x.to(torch.float32)
    dev = x.device
    ptr = st.piece_ptr.to(torch.int64)
    piece = torch.repeat_interleave(torch.arange(st.npieces, device=dev),
                                    ptr[1:] - ptr[:-1])
    off = torch.arange(st.nnz, device=dev) - ptr[piece]
    lane, step = piece * _WARP + off % _WARP, off // _WARP
    acc = torch.zeros(st.npieces * _WARP, dtype=torch.float32, device=dev)
    order = torch.argsort(step, stable=True)
    at = 0
    for c in (torch.bincount(step).tolist() if st.nnz else []):
        k = order[at:at + c]
        at += c
        prod = (st.vals[k].to(torch.float64)
                * x[st.cols[k].to(torch.int64)].to(torch.float64))
        acc[lane[k]] = (acc[lane[k]].to(torch.float64) + prod).to(
            torch.float32)
    v = acc.view(st.npieces, _WARP)
    off = _WARP // 2
    while off:
        v = v + v[:, torch.arange(_WARP, device=dev) ^ off]
        off //= 2
    piece_sum = v[:, 0]
    rp = st.row_piece.to(torch.int64)
    count = rp[1:] - rp[:-1]
    y = torch.zeros(st.m, dtype=torch.float32, device=dev)
    one = count == 1
    y[one] = piece_sum[rp[:-1][one]]
    multi = torch.nonzero(count > 1).view(-1)
    total = torch.zeros(multi.numel(), dtype=torch.float32, device=dev)
    for j in range(int(count.max()) if st.m else 0):
        live = count[multi] > j
        total[live] = total[live] + piece_sum[rp[multi[live]] + j]
    y[multi] = total
    return y


def split_decode(st: SplitStream):
    """(rows, cols, values) of every stored nonzero, each a flat tensor."""
    ptr = st.piece_ptr.to(torch.int64)
    rows = torch.repeat_interleave(st.piece_row.to(torch.int64),
                                   ptr[1:] - ptr[:-1])
    return rows, st.cols.to(torch.int64), st.vals


def describe(st) -> dict:
    """A pack's or a stream's rows, nonzeros, pieces, the most nonzeros a
    piece holds and the rows cut into more than one piece."""
    return {"rows": st.m, "nnz": st.nnz, "pieces": st.npieces,
            "piece": st.piece, "split_rows": st.split_rows}


@kernel("split_spmv", split_plain)
def split_spmv(st: SplitStream, x: torch.Tensor, stream: int) -> torch.Tensor:
    """y = A @ x over the pack, (m,) f32.  A CPU tensor takes the plain
    version; a CUDA tensor launches K13 (one launch, ``csr_split`` in
    ``profiling.launches``); any other device raises.  Each call lies
    inside the span ``spmv.kernel.csr_split`` (``ops.kernel``)."""
    y = torch.empty(st.m, dtype=torch.float32, device=x.device)
    partial = (torch.empty(st.npieces, dtype=torch.float32, device=x.device)
               if st.split_rows else None)
    _build.launch(
        st.kernel, "spmv_csr_split_launch", st.piece_ptr.data_ptr(),
        st.piece_row.data_ptr(), st.row_piece.data_ptr(),
        st.cols.data_ptr(), st.vals.data_ptr(), x.data_ptr(), y.data_ptr(),
        None if partial is None else partial.data_ptr(),
        tickets(st, (x.device.index, stream)).data_ptr(), st.npieces,
        stream)
    return y
