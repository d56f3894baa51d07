"""SELL tile-stream SpMV: the kernel ``csrc/sell.cu`` and its plain version.

Replaces the TPU kernel ``spmv_tpu/ops/pallas_sell.py::_kernel_v2`` (K1) in
both of its modes: row mode over a SELL-8W v2 stream
(``build_sell8w_v2_fn``) and slot mode over a SELL-8D stream (the resident
branch of ``build_sell8d_fn``), with f32, bf16 or palette values, window
bundles of 1, 2, 4 or 8 and the cell-shared window select (``cell_w``).

On the H100 the kernel is bound by the bytes of each padded slot (2 B of
meta, plus 2 B bf16 or 4 B f32 values; none for the palette) and by the
three dependent loads a slot makes (its meta, its cell's meta, x).  Its
design (see the source) cuts the stream into chunks of at most
``CHUNK_TILES`` tiles inside one output block, one CUDA block per chunk, and
adds each block's chunks in a second, ordered pass: no atomics.

Not carried over from the TPU: the SMEM scalar-prefetch chunking of
``_slot_chunks`` (one launch takes the whole stream here) and the zero
padding of x to a whole window bundle (columns >= n read 0 instead).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import _build
from ..formats import _bf16
from ..formats.sell8w import LANES, SUB, WINDOW
from ..utils.profiling import dev_put

__all__ = ["SellStream", "prepare_sell", "sell_spmv", "sell_plain",
           "row_launches", "slot_launches", "V2_MAX_N", "CHUNK_TILES"]

#: the JAX package's VMEM-resident-x bound; the port keeps it as the edge
#: of the slice (n > 2M SELL tiers are not ported yet)
V2_MAX_N = 2_000_000
#: most tiles one CUDA block takes (a chunk never straddles output blocks)
CHUNK_TILES = 64

#: kernel launches made by :func:`sell_spmv` in each mode
row_launches = 0
slot_launches = 0

_VALUE_MODES = {"f32": 0, "bf16": 1, "palette": 2}


@dataclasses.dataclass(frozen=True)
class SellStream:
    """Device arrays of one SELL tile stream plus its chunk tables."""

    slot_mode: bool
    value_mode: str               # "f32" | "bf16" | "palette"
    g: int                        # tiles per step
    nw: int                       # windows per bundle (slot mode)
    cell_w: bool                  # window select read at the cell
    m: int                        # rows of the stream (output cut to m)
    n: int
    nblocks: int                  # 1024-row output blocks
    meta: torch.Tensor            # (ntiles, 8, 128) int16
    vals: Optional[torch.Tensor]  # (ntiles, 8, 128) f32 / bf16, or None
    palette: torch.Tensor         # (128,) f32 (zeros unless palette mode)
    tinfo: torch.Tensor           # (ntiles,) int32
    step_block: torch.Tensor      # (nsteps,) int64 output block per step
    chunk_step_ptr: torch.Tensor  # (nchunks + 1,) int32
    block_chunk_ptr: torch.Tensor  # (nblocks + 1,) int32

    @property
    def nchunks(self) -> int:
        return self.chunk_step_ptr.numel() - 1


def chunk_tables(step_block: np.ndarray, nblocks: int, g: int):
    """(chunk_step_ptr, block_chunk_ptr) for a step → output-block map.

    The pack emits each block's steps contiguously, in block order (the
    invariant the TPU kernel's first-visit zeroing relies on); every run of
    one block's steps is cut into chunks of ``CHUNK_TILES // g`` steps."""
    sb = np.asarray(step_block, dtype=np.int64)
    if len(sb) and (np.any(np.diff(sb) < 0) or sb[0] < 0
                    or sb[-1] >= nblocks):
        raise ValueError("SELL stream: output blocks are not monotone "
                         "within [0, nblocks)")
    per = max(CHUNK_TILES // g, 1)
    first_of_block = np.searchsorted(sb, sb, side="left")
    starts = np.nonzero((np.arange(len(sb)) - first_of_block) % per == 0)[0]
    chunk_step_ptr = np.append(starts, len(sb)).astype(np.int32)
    block_chunk_ptr = np.searchsorted(
        sb[starts], np.arange(nblocks + 1), side="left").astype(np.int32)
    return chunk_step_ptr, block_chunk_ptr


def prepare_sell(packed, device, slot_mode: bool) -> SellStream:
    """Place a packed stream on ``device``: a ``Sell8WV2`` (row mode) or a
    ``Sell8D`` (slot mode), from either package (fields read by name)."""
    vm = packed.value_mode
    if vm not in _VALUE_MODES:
        raise NotImplementedError(
            f"SELL value mode {vm!r}: the f64 kernel (K2) is not ported yet "
            "(ROADMAP.md, 'Next slices', item 1)")
    nslices = packed.nslices
    nblocks = nslices if slot_mode else max(-(-nslices // SUB), 1)
    step_block = np.asarray(packed.ginfo).astype(np.int64) >> 1
    csp, bcp = chunk_tables(step_block, nblocks, packed.g)
    vals = None
    if vm == "bf16":
        vals = dev_put(_bf16.as_torch(np.asarray(packed.vals)
                                      .view(np.uint16)), device)
    elif vm == "f32":
        vals = dev_put(np.asarray(packed.vals, dtype=np.float32), device)
    pal = (np.asarray(packed.palette, dtype=np.float32)
           if vm == "palette" else np.zeros(LANES, np.float32))
    nw = int(getattr(packed, "nw", 1)) if slot_mode else 1
    return SellStream(
        slot_mode=slot_mode, value_mode=vm, g=int(packed.g), nw=nw,
        cell_w=bool(getattr(packed, "cell_w", False)) and slot_mode,
        m=int(packed.m), n=int(packed.n), nblocks=nblocks,
        meta=dev_put(np.asarray(packed.meta, dtype=np.int16), device),
        vals=vals, palette=dev_put(pal, device),
        tinfo=dev_put(np.asarray(packed.tinfo, dtype=np.int32), device),
        step_block=dev_put(step_block, device),
        chunk_step_ptr=dev_put(csp, device),
        block_chunk_ptr=dev_put(bcp, device))


def sell_plain(st: SellStream, x: torch.Tensor) -> torch.Tensor:
    """The plain version over the same packed arrays: decode every slot's
    column and value, gather x, and add the products into their rows with
    ``index_add_``.  Returns the (nblocks * 1024,) output."""
    x = x.to(torch.float32)
    dev = x.device
    out = torch.zeros(st.nblocks * WINDOW, dtype=torch.float32, device=dev)
    if st.n == 0 or st.meta.numel() == 0:
        return out
    meta = st.meta.to(torch.int64) & 0xFFFF                  # (T, 8, 128)
    r = meta & 127
    cell = torch.gather(meta, 2, r)                           # meta[t, i, r]
    s = (cell >> 7) & 7
    ti = st.tinfo.to(torch.int64)[:, None, None]
    lb = st.nw.bit_length() - 1
    if st.slot_mode:
        wsel = ((cell if st.cell_w else meta) >> 10) & (st.nw - 1)
        col = (ti >> 3) * (st.nw * WINDOW) + wsel * WINDOW + s * LANES + r
    else:
        col = (ti >> 3) * WINDOW + s * LANES + r
    if st.value_mode == "palette":
        v = st.palette[(meta >> (10 + lb)) & (63 >> lb)]
    else:
        v = st.vals.to(torch.float32)
    inb = col < st.n
    prod = v * torch.where(inb, x[col.clamp(max=st.n - 1)], 0.0)
    tile_block = st.step_block.repeat_interleave(st.g)        # (T,)
    if st.slot_mode:
        rows = (tile_block[:, None] * WINDOW
                + torch.arange(WINDOW, device=dev)).reshape(-1)
        out.index_add_(0, rows, prod.reshape(-1))
    else:
        rows = (tile_block[:, None] * WINDOW
                + (ti[:, 0] & 7) * LANES + torch.arange(LANES, device=dev))
        out.index_add_(0, rows.reshape(-1), prod.sum(1).reshape(-1))
    return out


def sell_spmv(st: SellStream, x: torch.Tensor) -> torch.Tensor:
    """Tile-stream product, (nblocks * 1024,) output.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel; any other device
    raises."""
    global row_launches, slot_launches
    if x.device.type == "cpu":
        return sell_plain(st, x)
    if x.device.type != "cuda":
        raise ValueError(f"sell_spmv: no kernel for device {x.device}")
    if (x.dtype != torch.float32 or x.shape != (st.n,)
            or not x.is_contiguous() or x.device != st.meta.device):
        raise ValueError(f"sell_spmv: x must be a contiguous float32 "
                         f"({st.n},) tensor on {st.meta.device}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    lib = _build.load_kernels()
    partial = torch.empty(st.nchunks * WINDOW, dtype=torch.float32,
                          device=x.device)
    out = torch.empty(st.nblocks * WINDOW, dtype=torch.float32,
                      device=x.device)
    err = lib.spmv_sell_launch(
        st.meta.data_ptr(),
        st.vals.data_ptr() if st.vals is not None else None,
        st.palette.data_ptr(), st.tinfo.data_ptr(),
        st.chunk_step_ptr.data_ptr(), st.block_chunk_ptr.data_ptr(),
        x.data_ptr(), partial.data_ptr(), out.data_ptr(),
        st.nchunks, st.nblocks, st.g, st.n, _VALUE_MODES[st.value_mode],
        int(st.slot_mode), st.nw, int(st.cell_w),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "sell_slot" if st.slot_mode else "sell_row")
    if st.slot_mode:
        slot_launches += 1
    else:
        row_launches += 1
    return out
