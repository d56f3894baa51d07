"""SELL-32-σ with explicit columns: the kernel ``csrc/sell_cs.cu`` (K12,
``sell_cs``) and its plain version.

K12 replaces no TPU kernel.  It runs the light part of an f32 row-split
hybrid on the card in place of the SELL-8D slot stream (K1 slot, which
replaces ``spmv_tpu/ops/pallas_sell.py::_kernel_v2`` in slot mode) where
``ops.use_card_layout`` picks it: there the slot stream is
mostly padding, which the TPU's x windows forced and the card's L2 does
not need.  The layout is ``formats/sell_cs.py``'s; the kernel is bound by
its two planes (8 B a slot) and the x gathers, which hit the L2 where x
fits it (see the source).

Each row is one thread's sum of its slots in slot order, one FMA a slot,
so a row's result is fixed and repeats bit for bit.  The plain version
adds the same slots in the same order; it rounds each step's product and
sum once, in f64, then to f32, which differs from the FMA only where that
double rounding does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _build
from ..formats.sell_cs import SLICE, SellCS
from ..utils.profiling import dev_put
from . import kernel

__all__ = ["CsStream", "prepare_cs", "cs_spmv", "cs_plain", "cs_decode",
           "KERNEL"]

#: the kernel's name in ``profiling.launches``; its span is
#: ``spmv.kernel.sell_cs``
KERNEL = "sell_cs"


@dataclasses.dataclass(frozen=True)
class CsStream:
    """Device arrays of one :class:`SellCS` pack."""

    m: int
    n: int
    nnz: int
    max_len: int                  # the longest slice's slots a row
    slice_ptr: torch.Tensor       # (nslices + 1,) int32
    rows: torch.Tensor            # (nslices * 32,) int32, -1 past m
    cols: torch.Tensor            # (nslots,) int32
    vals: torch.Tensor            # (nslots,) float32
    # the kernel's name and the type of x and y (class attributes)
    kernel = KERNEL
    dtype = torch.float32

    @property
    def nslices(self) -> int:
        return self.slice_ptr.numel() - 1

    @property
    def device(self) -> torch.device:
        return self.vals.device


def prepare_cs(p: SellCS, device) -> CsStream:
    """Place a pack on ``device``."""
    sp = np.asarray(p.slice_ptr, dtype=np.int32)
    return CsStream(
        m=int(p.m), n=int(p.n), nnz=int(p.nnz),
        max_len=int(np.diff(sp).max(initial=0)) // SLICE,
        slice_ptr=dev_put(sp, device),
        rows=dev_put(np.asarray(p.rows, dtype=np.int32), device),
        cols=dev_put(np.asarray(p.cols, dtype=np.int32), device),
        vals=dev_put(np.asarray(p.vals, dtype=np.float32), device))


def _slot_index(st: CsStream, j: int):
    """(the slices longer than j, the flat slot of (j, lane) in each), the
    second (k, 32) int64."""
    ptr = st.slice_ptr.to(torch.int64)
    live = torch.nonzero((ptr[1:] - ptr[:-1]) > j * SLICE).view(-1)
    lane = torch.arange(SLICE, device=ptr.device)
    return live, ptr[live][:, None] + j * SLICE + lane


def cs_plain(st: CsStream, x: torch.Tensor) -> torch.Tensor:
    """The plain version: every slice's slot j, for j = 0, 1, ..., added
    into its lane's sum in that order (``acc + v · x[c]`` in f64, rounded
    to f32 each step), then each lane's sum written to its row; the (m,)
    output is 0 at rows no lane owns."""
    x = x.to(torch.float32)
    acc = torch.zeros(st.nslices, SLICE, dtype=torch.float32,
                      device=x.device)
    for j in range(st.max_len):
        live, pos = _slot_index(st, j)
        prod = (st.vals[pos].to(torch.float64)
                * x[st.cols[pos].to(torch.int64)].to(torch.float64))
        acc[live] = (acc[live].to(torch.float64) + prod).to(torch.float32)
    rows = st.rows.to(torch.int64)
    own = rows >= 0
    y = torch.zeros(st.m, dtype=torch.float32, device=x.device)
    y[rows[own]] = acc.view(-1)[own]
    return y


def cs_decode(st: CsStream):
    """(rows, cols, values) of every stored nonzero slot, each a flat
    tensor (padding slots, whose value is 0, left out)."""
    out = []
    for j in range(st.max_len):
        live, pos = _slot_index(st, j)
        rows = st.rows.to(torch.int64).view(-1, SLICE)[live]
        keep = st.vals[pos] != 0
        out.append((rows[keep], st.cols[pos][keep].to(torch.int64),
                    st.vals[pos][keep]))
    if not out:
        e = torch.zeros(0, dtype=torch.int64, device=st.vals.device)
        return e, e, st.vals[:0]
    return tuple(torch.cat(t) for t in zip(*out))


@kernel("cs_spmv", cs_plain)
def cs_spmv(st: CsStream, x: torch.Tensor, stream: int) -> torch.Tensor:
    """y = A @ x over the pack, (m,) f32.  A CPU tensor takes the plain
    version; a CUDA tensor launches K12 (one launch, ``sell_cs`` in
    ``profiling.launches``); any other device raises.  Each call lies
    inside the span ``spmv.kernel.sell_cs`` (``ops.kernel``)."""
    y = torch.empty(st.m, dtype=torch.float32, device=x.device)
    _build.launch(st.kernel, "spmv_sell_cs_launch", st.slice_ptr.data_ptr(),
                  st.rows.data_ptr(), st.cols.data_ptr(), st.vals.data_ptr(),
                  x.data_ptr(), y.data_ptr(), st.nslices, stream)
    return y
