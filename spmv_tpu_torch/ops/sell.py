"""SELL tile-stream SpMV: the kernel ``csrc/sell.cu`` and its plain version.

Replaces the TPU's SELL tile kernels, each in both of its modes: row mode
over a SELL-8W v2 stream (``build_sell8w_v2_fn``, ``build_sell8w_v2w_fn``)
and slot mode over a SELL-8D stream (``build_sell8d_fn``), with window
bundles of 1, 2, 4 or 8 and the cell-shared window select (``cell_w``).
The TPU keeps x in VMEM up to :data:`V2_MAX_N` columns (K1, K2) and past
it DMAs one x window, or bundle of windows, a tile (K5-K7); the card reads
x from device memory at any column, so one kernel serves both, and
:func:`kernel_name` and the launch counts tell them apart by the stream's
n:

* ``spmv_tpu/ops/pallas_sell.py::_kernel_v2`` (K1, ``sell_row`` and
  ``sell_slot``): f32, bf16 or palette values, f32 x and y, n ≤ V2_MAX_N;
* ``spmv_tpu/ops/pallas_sell.py::_kernel_v2_df`` (K2, ``sell_row_df`` and
  ``sell_slot_df``): the double-float packs of f64 matrices (``df``,
  ``df16``, ``palette_df`` values), f64 x and y, n ≤ V2_MAX_N.  Each
  slot's value is decoded to one f64 (hi + lo, rounded once) and summed in
  native f64: the TPU's error-free transforms are not carried over;
* ``spmv_tpu/ops/pallas_sell.py::_make_kernel_v2w`` (K5): with values
  (``sell_row_w``), K1's row mode past V2_MAX_N; in its ``binary`` mode
  (``sell_row_bin``, any n), COO2's pass-2 reduce, every value 1 with
  validity in meta bit 15 and no values stream (:func:`binary_v2` builds
  the stream as ``build_sell8w_v2w_fn(binary=True)`` does), f32 x (the
  pass-1 products) and y;
* ``spmv_tpu/ops/pallas_sell.py::_make_kernel_v2w_slot`` (K6,
  ``sell_slot_w``): K1's slot mode past V2_MAX_N;
* ``spmv_tpu/ops/pallas_sell.py::_make_kernel_v2w_df`` (K7,
  ``sell_row_df_w`` and ``sell_slot_df_w``): K2 past V2_MAX_N;
* the v1 kernels, one tile a grid step over a ``Sell8W`` pack as
  :func:`build_sell8w_fn` and the mesh's dist SELL-8W plans store it
  (``window_ids``, ``gpk`` from :func:`pack_gpk`, int16 meta): ``_kernel``
  (K9, ``sell_v1``), f32 values; ``_kernel_v1_df`` (K10, ``sell_v1_df``),
  f32 hi + lo planes decoded to one f64 a slot, f64 x and y;
  ``_kernel_binary`` (K11, ``sell_v1_bin``), every value 1 with validity in
  meta bit 15.  :func:`prepare_v1` places them; the kernel reads the v1
  arrays as they are, in row mode with one tile a step.

A column stripe of a striped plan has the stripe's width as its n (at most
V2_MAX_N), so it runs as K1 or K2, as the JAX package runs ``_run_v2``
there.

On the H100 the kernel is bound by the bytes of the padded stream (2 B of
meta a slot, plus 2 B bf16, 4 B f32, 6 B df16 or 8 B df values; none for
the palettes and the binary mode).  Its design (see the source) keeps
those bytes in flight: :func:`chunk_tables` cuts the stream into chunks
sized to it (about :data:`CHUNKS_PER_SM` chunks an SM, at most
:data:`CHUNK_TILES` tiles, never across a 1024-row output block), one CUDA
block a chunk; a producer thread streams each chunk's tiles into a
shared-memory ring with bulk copies, and 128 consumer threads decode
their lane of each tile from shared memory, so the x gathers are the only
dependent global loads.  One launch a call: a block with several chunks is
added up, in chunk order, by whichever of its chunks finishes last (a
per-block ticket counter is the only atomic), so the result is
deterministic.  The tickets are the only state that launches over one
SELL stream share, so ``ops.tickets`` keeps a set for each CUDA stream it
is launched on: calls on two CUDA streams never count on each other's
tickets.  A CUDA graph captured over :func:`sell_spmv` binds the set of
the CUDA stream it was captured on, so one graph must not be replayed on
two streams at once (the rule its static buffers set already).

Not carried over from the TPU: the per-tile window DMAs of K5-K7 (a VMEM
workaround; the kernel's gathers read x where it lies), the SMEM
scalar-prefetch chunking of ``_slot_chunks`` (one launch takes the whole
stream here) and the zero padding of x to a whole window bundle (columns
>= n read 0 instead).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import _build
from ..formats import _bf16
from ..formats.sell8w import (LANES, SUB, WINDOW, Sell8W, Sell8WV2,
                              plan_v2, v2_layout)
from ..utils.profiling import dev_put
from . import kernel, tickets

__all__ = ["SellStream", "prepare_sell", "prepare_v1", "binary_v2",
           "pack_gpk", "build_sell8w_fn", "sell8w_spmv", "sell_spmv",
           "sell_plain", "sell_decode", "kernel_name", "KERNELS",
           "V2_MAX_N", "CHUNK_TILES", "CHUNKS_PER_SM", "MAX_REDUCE_BYTES",
           "H100_SMS", "chunk_len", "chunk_tables", "sm_count"]

#: the JAX package's VMEM-resident-x bound: streams up to it replace the
#: resident kernels (K1, K2), streams past it the windowed ones (K5-K7)
V2_MAX_N = 2_000_000
#: most tiles one CUDA block takes (a chunk never straddles output blocks)
CHUNK_TILES = 64
#: chunks a stream is cut into per SM, where it has the tiles: a short
#: stream still fills every SM for two waves of one block an SM; more
#: chunks cost more partial sums and pipeline fills than they win (1, 2, 4
#: and 8 measured on the H100)
CHUNKS_PER_SM = 2
#: most bytes of partial sums the last chunk of an output block reads back
#: (1024 rows a chunk: 256 chunks in f32, 128 in f64), so a stream of few,
#: long output blocks gets longer chunks instead of more
MAX_REDUCE_BYTES = 1 << 20
#: the SM count chunk tables assume for a stream placed on the CPU (the
#: H100's), so the CPU tests see the card's chunking
H100_SMS = 132
#: most tiles the plain version decodes at once (its int64 temporaries
#: stay near 0.5 GB each on full-size streams)
PLAIN_TILES = 1 << 16

#: the names of the kernel's instantiations (:func:`kernel_name`), under
#: which ``profiling.launches`` counts their launches: f32 (K1) and f64
#: (K2) streams up to V2_MAX_N, their windowed counterparts (K5 values,
#: K6, K7) past it, binary (K5 binary) streams, and the v1 streams (K9,
#: K10, K11)
KERNELS = ("sell_row", "sell_slot", "sell_row_df", "sell_slot_df",
           "sell_row_bin", "sell_row_w", "sell_slot_w", "sell_row_df_w",
           "sell_slot_df_w", "sell_v1", "sell_v1_df", "sell_v1_bin")

_VALUE_MODES = {"f32": 0, "bf16": 1, "palette": 2,
                "df": 3, "df16": 4, "palette_df": 5, "binary": 6}
#: the double-float value modes of f64 matrices
DF_MODES = ("df", "df16", "palette_df")


@dataclasses.dataclass(frozen=True)
class SellStream:
    """Device arrays of one SELL tile stream plus its chunk tables."""

    slot_mode: bool
    value_mode: str               # a key of _VALUE_MODES
    g: int                        # tiles per step
    nw: int                       # windows per bundle (slot mode)
    cell_w: bool                  # window select read at the cell
    m: int                        # rows of the stream (output cut to m)
    n: int
    nblocks: int                  # 1024-row output blocks
    meta: torch.Tensor            # (ntiles, 8, 128) int16
    vals: Optional[torch.Tensor]  # (ntiles, 8, 128) f32 / bf16 (the hi
    #                               plane in df modes), None for palettes
    #                               and binary
    vals_lo: Optional[torch.Tensor]  # (ntiles, 8, 128) f32 (df) or int16
    #                                  (df16), else None
    palette: torch.Tensor         # (128,) f32, f64 (hi + lo) in palette_df;
    #                               zeros outside the palette modes
    tinfo: torch.Tensor           # (ntiles,) int32; window_ids in v1
    step_block: torch.Tensor      # (nsteps,) int64 output block per step
    chunk_step_ptr: torch.Tensor  # (nchunks + 1,) int32
    chunk_block: torch.Tensor     # (nchunks,) int32 output block per chunk
    block_chunk_ptr: torch.Tensor  # (nblocks + 1,) int32
    gpk: Optional[torch.Tensor] = None  # (ntiles,) int32, the v1 layout's
    #                                     group << 4 | row << 1 | first
    #: the kernel's last-chunk counters, (nblocks,) int32 zeros that each
    #: launch leaves 0, one set a CUDA stream: (device index, cuda_stream)
    #: → tensor, made by ``ops.tickets`` (a ``dataclasses.replace`` copy
    #: starts with none)
    tickets_by_stream: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)
    #: the name of the kernel that runs it (:func:`kernel_name`)
    kernel: str = dataclasses.field(init=False, repr=False, compare=False)
    #: what every launch passes that is fixed per stream (CUDA streams)
    _launch: Optional[tuple] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "kernel", kernel_name(self))
        if self.meta.device.type == "cuda":
            object.__setattr__(self, "_launch", _launch_args(self))

    @property
    def nchunks(self) -> int:
        return self.chunk_step_ptr.numel() - 1

    @property
    def ntickets(self) -> int:
        return self.nblocks

    @property
    def device(self) -> torch.device:
        return self.meta.device

    @property
    def dtype(self) -> torch.dtype:
        """The type of x and y: f64 for the double-float modes."""
        return (torch.float64 if self.value_mode in DF_MODES
                else torch.float32)


def chunk_len(ntiles: int, nsm: int) -> int:
    """Tiles a chunk takes in a stream of ``ntiles`` tiles on ``nsm`` SMs:
    about :data:`CHUNKS_PER_SM` chunks an SM, between 1 and
    :data:`CHUNK_TILES` tiles."""
    return max(1, min(CHUNK_TILES, ntiles // (CHUNKS_PER_SM * nsm)))


def chunk_tables(step_block: np.ndarray, nblocks: int, g: int, nsm: int,
                 esize: int = 4):
    """(chunk_step_ptr, chunk_block, block_chunk_ptr) for a step →
    output-block map, one CUDA block a chunk; ``esize`` is the bytes of an
    output element (8 in the double-float modes).

    The pack emits each block's steps contiguously, in block order (the
    invariant the TPU kernel's first-visit zeroing relies on); every run of
    one block's steps is cut into chunks of ``chunk_len(tiles, nsm) // g``
    steps (at least one; more where the run would otherwise take more
    chunks than :data:`MAX_REDUCE_BYTES` of partial sums hold), and an
    output block with no steps gets one empty chunk, which writes its
    zeros.  A block's chunks are contiguous, so its partial sums sit in
    rows block_chunk_ptr[b] .. [b + 1] of the kernel's (nchunks, 1024)
    scratch and are added in that order."""
    sb = np.asarray(step_block, dtype=np.int64)
    if len(sb) and (np.any(np.diff(sb) < 0) or sb[0] < 0
                    or sb[-1] >= nblocks):
        raise ValueError("SELL stream: output blocks are not monotone "
                         "within [0, nblocks)")
    per = max(chunk_len(len(sb) * g, nsm) // g, 1)
    blocks = np.arange(nblocks)
    bare = np.searchsorted(sb, blocks, side="left")
    run = np.searchsorted(sb, blocks, side="right") - bare
    most = max(MAX_REDUCE_BYTES // (WINDOW * esize), 1)
    per_block = np.maximum(per, -(-run // most))
    starts = np.nonzero((np.arange(len(sb)) - bare[sb]) % per_block[sb]
                        == 0)[0]
    empty = run == 0
    first = np.concatenate([starts, bare[empty]])
    owner = np.concatenate([sb[starts], blocks[empty]])
    order = np.lexsort((owner, first))
    chunk_step_ptr = np.append(first[order], len(sb)).astype(np.int32)
    chunk_block = owner[order].astype(np.int32)
    block_chunk_ptr = np.searchsorted(
        chunk_block, np.arange(nblocks + 1), side="left").astype(np.int32)
    return chunk_step_ptr, chunk_block, block_chunk_ptr


def sm_count(device) -> int:
    """The SM count of a CUDA device, :data:`H100_SMS` for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).multi_processor_count
    return H100_SMS


def _placed_tables(step_block: np.ndarray, nblocks: int, g: int, device,
                   nsm: Optional[int], value_mode: str):
    """The chunk tables of a stream, on ``device``."""
    csp, cb, bcp = chunk_tables(step_block, nblocks, g,
                                sm_count(device) if nsm is None else nsm,
                                8 if value_mode in DF_MODES else 4)
    return dict(step_block=dev_put(step_block, device),
                chunk_step_ptr=dev_put(csp, device),
                chunk_block=dev_put(cb, device),
                block_chunk_ptr=dev_put(bcp, device))


def binary_v2(packed: Sell8W, g: int = 16) -> Sell8WV2:
    """COO2's R as a binary row-mode stream, as
    ``build_sell8w_v2w_fn(packed, g, binary=True)`` builds it: ``plan_v2``'s
    grouping (tinfo, ginfo), and meta rebuilt from the v1 pack with each
    slot's validity (value != 0) in bit 15, placed by the same ``dest``.
    The palette ``plan_v2`` picks for an all-ones R is dropped."""
    v2 = plan_v2(packed, g=g)
    valid = packed.vals != 0
    meta16 = (packed.meta.astype(np.int32)
              | (valid.astype(np.int32) << 15)) & 0xFFFF
    meta = np.zeros_like(v2.meta)
    meta[v2_layout(packed, g)[1]] = meta16.astype(np.uint16).view(np.int16)
    return dataclasses.replace(v2, value_mode="binary", meta=meta, vals=None,
                               palette=None)


def pack_gpk(slice_ids) -> np.ndarray:
    """The v1 layout's per-tile scalar, ``group << 4 | row_in_group << 1 |
    first`` (``spmv_tpu/ops/pallas_sell.py:pack_gpk``)."""
    sl = np.asarray(slice_ids).astype(np.int64)
    groups = sl // SUB
    first = np.ones(len(sl), dtype=np.int64)
    first[1:] = (groups[1:] != groups[:-1]).astype(np.int64)
    return (groups << 4 | (sl % SUB) << 1 | first).astype(np.int32)


def binary_meta_v1(packed: Sell8W) -> np.ndarray:
    """A v1 pack's meta with each slot's validity (value != 0) in bit 15,
    as ``build_sell8w_fn(binary=True)`` builds it."""
    meta = packed.meta.astype(np.int32) | ((packed.vals != 0)
                                           .astype(np.int32) << 15)
    return (meta & 0xFFFF).astype(np.uint16).view(np.int16)


def prepare_v1(window_ids, gpk, meta, vals, nslices: int, m: int, n: int,
               device, vals_lo=None, nsm: Optional[int] = None) -> SellStream:
    """Place a v1 stream on ``device``: ``window_ids`` and ``gpk`` (ntiles,)
    int32, meta (ntiles, 8, 128) int16 and f32 values, as the JAX package
    stores them.  ``vals`` None is the binary mode (validity in meta bit
    15); ``vals_lo`` given is the double-float mode (hi + lo f32 planes).
    Output blocks are the groups of 8 slices, taken from ``gpk >> 4``.
    Chunks are sized for ``nsm`` SMs (default: the device's,
    :data:`H100_SMS` on the CPU)."""
    vm = ("binary" if vals is None else "df" if vals_lo is not None
          else "f32")
    nblocks = max(-(-nslices // SUB), 1)
    step_block = np.asarray(gpk).astype(np.int64) >> 4
    f32 = lambda v: dev_put(np.asarray(v, dtype=np.float32), device)  # noqa: E731
    return SellStream(
        slot_mode=False, value_mode=vm, g=1, nw=1, cell_w=False, m=int(m),
        n=int(n), nblocks=nblocks,
        meta=dev_put(np.asarray(meta, dtype=np.int16), device),
        vals=None if vals is None else f32(vals),
        vals_lo=None if vals_lo is None else f32(vals_lo),
        palette=dev_put(np.zeros(LANES, np.float64 if vm == "df"
                                 else np.float32), device),
        tinfo=dev_put(np.asarray(window_ids, dtype=np.int32), device),
        **_placed_tables(step_block, nblocks, 1, device, nsm, vm),
        gpk=dev_put(np.asarray(gpk, dtype=np.int32), device))


def build_sell8w_fn(packed: Sell8W, binary: bool = False, device="cuda"):
    """``x -> y`` over a v1 pack placed on ``device``
    (``spmv_tpu/ops/pallas_sell.py:build_sell8w_fn``): K9 over its f32
    values, or K11 with ``binary=True`` (every stored value 1, validity in
    meta bit 15, no values stream)."""
    st = prepare_v1(packed.window_ids, pack_gpk(packed.slice_ids),
                    binary_meta_v1(packed) if binary else packed.meta,
                    None if binary else packed.vals, packed.nslices,
                    packed.m, packed.n, device)
    return lambda x: sell_spmv(st, x)[:st.m]


def sell8w_spmv(packed: Sell8W, x: torch.Tensor) -> torch.Tensor:
    """One v1 product on ``x``'s device."""
    return build_sell8w_fn(packed, device=x.device)(x)


def prepare_sell(packed, device, slot_mode: bool,
                 nsm: Optional[int] = None) -> SellStream:
    """Place a packed stream on ``device``: a ``Sell8WV2`` (row mode) or a
    ``Sell8D`` (slot mode), from either package (fields read by name).
    Chunks are sized for ``nsm`` SMs (default: the device's,
    :data:`H100_SMS` on the CPU)."""
    vm = packed.value_mode
    if vm not in _VALUE_MODES:
        raise ValueError(f"SELL value mode {vm!r} has no kernel")
    nslices = packed.nslices
    nblocks = nslices if slot_mode else max(-(-nslices // SUB), 1)
    step_block = np.asarray(packed.ginfo).astype(np.int64) >> 1
    vals = vals_lo = None
    if vm == "bf16":
        vals = dev_put(_bf16.as_torch(np.asarray(packed.vals)
                                      .view(np.uint16)), device)
    elif vm in ("f32", "df", "df16"):
        vals = dev_put(np.asarray(packed.vals, dtype=np.float32), device)
    if vm == "df":
        vals_lo = dev_put(np.asarray(packed.vals_lo, dtype=np.float32),
                          device)
    elif vm == "df16":
        vals_lo = dev_put(np.asarray(packed.vals_lo, dtype=np.int16), device)
    if vm == "palette":
        pal = np.asarray(packed.palette, dtype=np.float32)
    elif vm == "palette_df":
        # one f64 per entry: hi + lo, rounded once
        pal = (np.asarray(packed.palette, dtype=np.float64)
               + np.asarray(packed.palette_lo, dtype=np.float64))
    else:
        pal = np.zeros(LANES, np.float64 if vm in DF_MODES else np.float32)
    nw = int(getattr(packed, "nw", 1)) if slot_mode else 1
    return SellStream(
        slot_mode=slot_mode, value_mode=vm, g=int(packed.g), nw=nw,
        cell_w=bool(getattr(packed, "cell_w", False)) and slot_mode,
        m=int(packed.m), n=int(packed.n), nblocks=nblocks,
        meta=dev_put(np.asarray(packed.meta, dtype=np.int16), device),
        vals=vals, vals_lo=vals_lo, palette=dev_put(pal, device),
        tinfo=dev_put(np.asarray(packed.tinfo, dtype=np.int32), device),
        **_placed_tables(step_block, nblocks, int(packed.g), device, nsm,
                         vm))


def _slot_values(st: SellStream, t0: int, t1: int) -> torch.Tensor:
    """The value of every slot of tiles [t0, t1), (t1 - t0, 8, 128), in
    the stream's type."""
    meta = st.meta[t0:t1]
    if st.value_mode == "binary":
        return ((meta.to(torch.int64) & 0x8000) != 0).to(torch.float32)
    if st.value_mode in ("palette", "palette_df"):
        lb = st.nw.bit_length() - 1
        return st.palette[((meta.to(torch.int64) & 0xFFFF) >> (10 + lb))
                          & (63 >> lb)]
    vals = st.vals[t0:t1]
    if st.value_mode not in DF_MODES:
        return vals.to(torch.float32)
    hi = vals.to(torch.float64)
    if st.value_mode == "df":
        return hi + st.vals_lo[t0:t1].to(torch.float64)
    # df16: lo = q · floor-pow2(|hi|) · 2^-39, the scale from hi's exponent
    # bits (0 for a zero or subnormal hi), as _df16_decode computes it
    pulse = (vals.view(torch.int32) & 0x7F800000).view(torch.float32)
    scale = (pulse * 2.0 ** -39).to(torch.float64)
    return hi + st.vals_lo[t0:t1].to(torch.float64) * scale


def sell_decode(st: SellStream, t0: int = 0, t1: Optional[int] = None):
    """(rows, cols, values) of every slot of tiles [t0, t1) (all tiles by
    default), each (t1 - t0, 8, 128): rows index the (nblocks * 1024,)
    output (in row mode the 8 sublanes of a slot column share one row);
    columns may be >= n on padding slots."""
    t1 = st.meta.shape[0] if t1 is None else min(t1, st.meta.shape[0])
    dev = st.meta.device
    meta = st.meta[t0:t1].to(torch.int64) & 0xFFFF           # (T, 8, 128)
    r = meta & 127
    cell = torch.gather(meta, 2, r)                           # meta[t, i, r]
    s = (cell >> 7) & 7
    ti = st.tinfo[t0:t1].to(torch.int64)[:, None, None]
    if st.gpk is not None:
        # v1: tinfo is window_ids, the row in the group is in gpk
        ti = ti << 3 | (st.gpk[t0:t1].to(torch.int64)[:, None, None] >> 1
                        & 7)
    if st.slot_mode:
        wsel = ((cell if st.cell_w else meta) >> 10) & (st.nw - 1)
        col = (ti >> 3) * (st.nw * WINDOW) + wsel * WINDOW + s * LANES + r
    else:
        col = (ti >> 3) * WINDOW + s * LANES + r
    step = torch.arange(t0, t1, device=dev) // st.g
    tile_block = st.step_block[step][:, None, None]
    lane = torch.arange(LANES, device=dev)
    if st.slot_mode:
        rows = (tile_block * WINDOW
                + torch.arange(SUB, device=dev)[None, :, None] * LANES
                + lane)
    else:
        rows = (tile_block * WINDOW + (ti & 7) * LANES
                + lane).expand(-1, SUB, -1)
    return rows, col, _slot_values(st, t0, t1)


def sell_plain(st: SellStream, x: torch.Tensor) -> torch.Tensor:
    """The plain version over the same packed arrays: decode every slot's
    column and value, gather x, and add the products into their rows with
    ``index_add_``, :data:`PLAIN_TILES` tiles at a time.  Returns the
    (nblocks * 1024,) output, f32 for an f32 stream and f64 for a
    double-float one (f32 for a binary stream)."""
    x = x.to(st.dtype)
    out = torch.zeros(st.nblocks * WINDOW, dtype=st.dtype, device=x.device)
    if st.n == 0:
        return out
    for t0 in range(0, st.meta.shape[0], PLAIN_TILES):
        rows, col, v = sell_decode(st, t0, t0 + PLAIN_TILES)
        xg = torch.where(col < st.n, x[col.clamp(max=st.n - 1)], 0.0)
        del col
        # binary: K5 selects x at the valid slots (a padding slot adds 0
        # even where x is not finite)
        prod = (torch.where(v != 0, xg, 0.0) if st.value_mode == "binary"
                else v * xg)
        if st.slot_mode:
            out.index_add_(0, rows.reshape(-1), prod.reshape(-1))
        else:
            out.index_add_(0, rows[:, 0].reshape(-1),
                           prod.sum(1).reshape(-1))
    return out


def kernel_name(st: SellStream) -> str:
    """The name of the kernel that runs ``st``: sell_row, sell_slot, their
    f64 forms sell_row_df and sell_slot_df, each with the suffix ``_w``
    past V2_MAX_N (K5 values, K6, K7), sell_row_bin, or for a v1 stream
    sell_v1, sell_v1_df or sell_v1_bin (K9, K10, K11)."""
    if st.gpk is not None:
        return "sell_v1" + {"f32": "", "df": "_df",
                            "binary": "_bin"}[st.value_mode]
    if st.value_mode == "binary":
        return "sell_row_bin"
    return (("sell_slot" if st.slot_mode else "sell_row")
            + ("_df" if st.value_mode in DF_MODES else "")
            + ("_w" if st.n > V2_MAX_N else ""))


def _launch_args(st: SellStream):
    """(the arguments before the tickets, those after x) of every launch
    over ``st``: fixed per stream (the pointers, the value
    mode; the ring's size follows from the value mode inside the kernel),
    computed once when it is placed.  Raises when a bulk-copied plane is
    not 16-B aligned."""
    for t in (st.meta, st.vals, st.vals_lo):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("sell stream: meta and value planes must be "
                             "16-B aligned for the kernel's bulk copies")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    before = (ptr(st.meta), ptr(st.vals), ptr(st.vals_lo), ptr(st.palette),
              ptr(st.tinfo), ptr(st.gpk), ptr(st.chunk_step_ptr),
              ptr(st.chunk_block), ptr(st.block_chunk_ptr))
    after = (st.nchunks, st.g, st.n, _VALUE_MODES[st.value_mode],
             int(st.slot_mode), st.nw, int(st.cell_w))
    return before, after


@kernel("sell_spmv", sell_plain)
def sell_spmv(st: SellStream, x: torch.Tensor, stream: int) -> torch.Tensor:
    """Tile-stream product, (nblocks * 1024,) output.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel; any other device
    raises.  x is f32 for an f32 or binary stream and f64 for a
    double-float one.  Each launch adds one to the count of its kernel
    name in ``profiling.launches``; each call, on the card or the CPU,
    lies inside the span ``spmv.kernel.<kernel name>`` (``ops.kernel``)."""
    if not st.slot_mode and x.data_ptr() % 16:
        x = x.clone()       # row mode bulk-copies x windows: 16-B aligned
    before, after = st._launch
    # partial sums only where an output block has several chunks
    partial = (torch.empty(st.nchunks * WINDOW, dtype=st.dtype,
                           device=x.device)
               if st.nchunks > st.nblocks else None)
    out = torch.empty(st.nblocks * WINDOW, dtype=st.dtype, device=x.device)
    _build.launch(
        st.kernel, "spmv_sell_launch", *before,
        tickets(st, (x.device.index, stream)).data_ptr(), x.data_ptr(),
        None if partial is None else partial.data_ptr(), out.data_ptr(),
        *after, stream)
    return out
