"""The planner's calibration on the card: the nine ``baselines/`` probes of
the JAX package (P1-P9) as the micro-kernels of ``csrc/probes.cu``, each
beside its plain PyTorch version, and the co-timings of the port's real
SELL kernels that :func:`..formats.prices.derive_prices` turns into a
price table.

Kernels (a wrapper each; a CPU tensor takes the plain version, a CUDA
tensor launches the kernel, any other device raises; each launch adds one
to the wrapper's count):

* :func:`tile_stream` — P1 (``probe2_stream.py:make_stream_fn``), P3
  (``probe3_v2proto.py:pallas_huge``), P7
  (``probe_step_overhead.py:_acc_kernel``): (ntiles, 8, 128) f32 tiles
  summed B a step, into one carried (8, 128) sum or one sum a step;
* :func:`tile_body` — P2 (``probe2_stream.py:make_g8_fn``), P4
  (``probe3_v2proto.py:v2_proto``), P5 (``probe4_body.py:build``): the SELL
  row-mode body over G tiles a step, with the value mode, the gather
  stages, the row mask and the per-tile window as switches;
* :func:`window_gather` — P9 (``probe_wide_gather_r5.py:kern_loop``,
  ``kern_wide``): an 8-window take0 + take1 + select loop against one wide
  gather over an (8, 1024) bundle;
* :func:`tiny` — P6 (``probe5_floor.py:tiny_pallas``): one (8, 128) tile
  times 2; :func:`tiny_chain` launches it ``n`` times from one C call, the
  counterpart of the TPU probe's compiled loop;
* :func:`fma_err` — P8 (``probe_r4_compute.py:probe_fma``): ``a·b − p``
  with ``p = fl(a·b)``.  On sm_90 the kernel is one IEEE fused
  multiply-add (``__fmaf_rn``), so the error comes out exact; the probe
  asserts it does.

``tiny`` and ``fma_err`` launch with programmatic dependent launch (sm_90):
a launch may start while the kernel before it runs and waits for it before
its first read.

The probe functions (``probe_*``) build their input as the JAX probe does
and return its figures under the JAX probe's JSON field names (``variant``,
``ms``, ``gbs``, ...).  A probe runs on the card unless ``device="cpu"`` is
asked for, and then on the plain versions (its times are then the CPU's,
not the card's).  :func:`calibrate` adds the figures that come from the
real kernels (the JAX package's ``probe_cell_w_r5``, ``probe_webbase_r4e``,
``probe_df_costs`` and ``probe_webbase_r4b`` methods) and returns the named
figures :func:`derive_prices` reads.

Run on the card: ``python3 chip_smoke.py`` (its ``prices`` phase); on the
CPU at a small size: ``tests/test_torch_probes.py``.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
import weakref
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import _build
from ..formats import _bf16
from ..formats.sell8w import LANES, SUB, WINDOW
from ..ops.sell import sm_count
from ..utils.profiling import launches
from . import timing

__all__ = ["tile_stream", "tile_stream_plain", "tile_body", "tile_body_plain",
           "window_gather", "window_gather_plain", "tiny", "tiny_plain",
           "tiny_chain", "tiny_chain_plain", "chain_ms", "fma_err",
           "fma_err_plain", "Split", "stream_split", "body_split",
           "gather_split", "tile_stream_order", "window_gather_order",
           "STREAM_INPUTS", "body_inputs", "flush_l2", "probe_inputs",
           "probe_stream", "probe_g8", "probe_huge", "probe_v2proto",
           "probe_body", "probe_tiny", "probe_step", "probe_fma",
           "probe_wide_gather", "p9_arrays", "run_probes", "calibrate",
           "KERNELS"]

#: the probe kernels, under whose names ``profiling.launches`` counts their
#: launches
KERNELS = ("tile_stream", "tile_body", "window_gather", "tiny", "fma_err")

#: the value modes and gather stages of :func:`tile_body`
BODY_VALUES = {"f32": 0, "bf16": 1, "palette": 2, "dyadic": 3}
BODY_GATHERS = {"full": 0, "no_dim1": 1, "none": 2}
#: P9's bundle: 8 windows of 1024 columns
P9_NW = 8


def _count(name: str, n: int = 1) -> None:
    launches[name] += n


def _on_card(name: str, *ts: torch.Tensor) -> bool:
    """False for CPU tensors (the plain version runs); True for contiguous
    CUDA tensors on one device; raises for anything else."""
    dev = ts[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in ts:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: every input must be a contiguous "
                             f"tensor on {dev}")
    return True


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


#: chunks a tile stream is cut into an SM (256 threads a block, the whole
#: grid resident at once; four ran slower on the H100: more slots)
STREAM_CHUNKS_PER_SM = 2
#: chunks a body stream is cut into an SM (160 threads a block)
BODY_CHUNKS_PER_SM = 4
#: slots a node of the fixed-order reduce sums (``csrc/probes.cu`` kFan)
REDUCE_FAN = 16
#: most tiles a window_gather block holds in shared memory beside the x
#: bundle (``csrc/probes.cu`` kGatherTiles: 80 KB a block in the loop form)
GATHER_TILES = 4
#: window_gather blocks an SM (two of 80 KB fit in its shared memory)
GATHER_BLOCKS_PER_SM = 2


@dataclasses.dataclass(frozen=True)
class Split:
    """How a kernel of ``csrc/probes.cu`` cuts its tiles into chunks (one
    CUDA block a chunk) and reduces each output cut over several chunks:
    one partial a piece (a slot), the slots of split output k summed in
    order by nodes of :data:`REDUCE_FAN`, then the nodes in order.  int32
    host tables."""

    #: (nchunks, 4): tile_lo, tile_hi, then (tile_stream) the chunk's slot
    #: or -1 and its output, (tile_body) its runs' bounds in ``runs``,
    #: (window_gather) step_lo, step_hi
    chunks: np.ndarray
    slot_out: np.ndarray          # (nslots,): each slot's split output
    slot_ptr: np.ndarray          # (nsplit + 1,): slots of each
    node_ptr: np.ndarray          # (nsplit + 1,): nodes of each
    #: tile_body: (nruns, 4): a run's end tile, its group, its slot or -1
    runs: Optional[np.ndarray] = None
    #: tile_body: the groups no tile visits (zero-filled)
    zero_groups: Optional[np.ndarray] = None
    #: window_gather: (nchunks,) the slot a chunk writes, -1 for the output
    #: itself, -2 for nothing
    writes: Optional[np.ndarray] = None

    @property
    def nslots(self) -> int:
        return int(self.slot_ptr[-1])

    @property
    def nnodes(self) -> int:
        return int(self.node_ptr[-1])

    @property
    def ntickets(self) -> int:
        """Tickets a launch uses: one a node, then one a split output."""
        return self.nnodes + len(self.slot_ptr) - 1


def _i32(*cols) -> np.ndarray:
    return np.ascontiguousarray(np.stack(cols, axis=1).astype(np.int32))


def _tree(counts) -> tuple:
    """(slot_out, slot_ptr, node_ptr) of split outputs of ``counts``
    slots each."""
    counts = np.asarray(counts, np.int64)
    slot_ptr = np.concatenate([[0], np.cumsum(counts)])
    node_ptr = np.concatenate([[0], np.cumsum(-(-counts // REDUCE_FAN))])
    return (np.repeat(np.arange(len(counts)), counts).astype(np.int32),
            slot_ptr.astype(np.int32), node_ptr.astype(np.int32))


def _even(total: int, n: int) -> np.ndarray:
    """n + 1 bounds cutting [0, total) into n near-equal runs."""
    return total * np.arange(n + 1, dtype=np.int64) // n


def stream_split(nsteps: int, block: int, accumulate: bool,
                 nsm: int) -> Split:
    """:func:`tile_stream`'s chunks over the ``nsteps · block`` tiles, about
    :data:`STREAM_CHUNKS_PER_SM` an SM whatever ``block`` is.  With
    ``accumulate`` the one output is cut evenly (a slot a chunk, or one
    chunk writing it); without, chunks of whole steps write each step as
    it ends, or a step longer than a chunk is cut into parts (a slot each).
    ``chunks[c]`` = (tile_lo, tile_hi, slot or -1, output)."""
    T = nsteps * block
    if T >= 2 ** 31:
        raise ValueError("tile_stream: at most 2^31 - 1 tiles")
    target = max(-(-T // (nsm * STREAM_CHUNKS_PER_SM)), 1)
    if accumulate:
        b = _even(T, max(-(-T // target), 1))
        n = len(b) - 1
        slot = np.arange(n) if n > 1 else np.full(1, -1)
        tree = _tree([n] if n > 1 else [])
        return Split(_i32(b[:-1], b[1:], slot, np.zeros(n)), *tree)
    if block <= target:
        s = _even(nsteps, min(nsteps, nsm * STREAM_CHUNKS_PER_SM))
        n = len(s) - 1
        return Split(_i32(s[:-1] * block, s[1:] * block, np.full(n, -1),
                          np.full(n, -1)), *_tree([]))
    parts = -(-block // target)
    step = np.repeat(np.arange(nsteps), parts)
    i = np.tile(np.arange(parts), nsteps)
    return Split(_i32(step * block + block * i // parts,
                      step * block + block * (i + 1) // parts,
                      np.arange(nsteps * parts), step),
                 *_tree(np.full(nsteps, parts)))


def body_split(ginfo: np.ndarray, g: int, ngroups: int, nsm: int) -> Split:
    """:func:`tile_body`'s chunks: the ``len(ginfo) · g`` tiles cut evenly
    into about :data:`BODY_CHUNKS_PER_SM` chunks an SM, across steps and
    groups; each chunk's runs (its tiles of one group, in order) end in a
    direct write of the group, or, for a group with more than one run in
    the stream (cut by a chunk boundary, or visited twice), in a slot of
    the reduce.  A run's init comes from the steps it opens (ginfo & 1 at
    a step's first tile), so a group gets it once however it is cut.
    ``chunks[c]`` = (tile_lo, tile_hi, run_lo, run_hi)."""
    gi = np.asarray(ginfo, np.int64)
    T = len(gi) * g
    if T >= 2 ** 31:
        raise ValueError("tile_body: at most 2^31 - 1 tiles")
    grp = np.repeat(gi >> 1, g)
    if T and (grp.min() < 0 or grp.max() >= ngroups):
        raise ValueError("tile_body: ginfo names a group outside ngroups")
    target = max(-(-T // (nsm * BODY_CHUNKS_PER_SM)), 1)
    cb = _even(T, max(-(-T // target), 1))
    starts = np.union1d(cb[:-1], np.flatnonzero(grp[1:] != grp[:-1]) + 1)
    ends = np.append(starts[1:], T)
    pg = grp[starts]
    cnt = np.bincount(pg, minlength=ngroups)
    split = np.flatnonzero(cnt[pg] > 1)
    order = split[np.lexsort((starts[split], pg[split]))]
    slot = np.full(len(starts), -1, np.int64)
    slot[order] = np.arange(len(order))
    pc = np.searchsorted(cb, starts, side="right") - 1
    nc = np.arange(len(cb) - 1)
    return Split(_i32(cb[:-1], cb[1:], np.searchsorted(pc, nc, "left"),
                      np.searchsorted(pc, nc, "right")),
                 *_tree(cnt[np.unique(pg[split])]),
                 runs=_i32(ends, pg, slot, np.zeros(len(starts))),
                 zero_groups=np.flatnonzero(cnt == 0).astype(np.int32))


def gather_split(g: int, nsteps: int, nsm: int) -> Split:
    """:func:`window_gather`'s chunks over its ``nsteps · g`` (step, tile)
    gathers: the g tiles cut evenly into groups of at most
    :data:`GATHER_TILES`, each group's steps cut evenly into runs, enough
    for about :data:`GATHER_BLOCKS_PER_SM` chunks an SM in all.  Every
    step of a group gives the same sum, so the chunk of its first run
    writes it: straight to the output when one group holds all g tiles,
    else into the group's slot of the reduce, which adds the groups in
    tile order; the other chunks write nothing.  ``chunks[c]`` =
    (tile_lo, tile_hi, step_lo, step_hi), a group's runs in step order."""
    if g < 1 or nsteps < 1:
        raise ValueError("window_gather: at least one tile and one step")
    if g * nsteps >= 2 ** 31:
        raise ValueError("window_gather: at most 2^31 - 1 tile-gathers")
    ngroups = -(-g // GATHER_TILES)
    tiles = _even(g, ngroups)
    nruns = max(1, min(nsteps, -(-nsm * GATHER_BLOCKS_PER_SM // ngroups)))
    steps = _even(nsteps, nruns)
    grp = np.repeat(np.arange(ngroups), nruns)
    run = np.tile(np.arange(nruns), ngroups)
    writes = np.where(run > 0, -2, grp if ngroups > 1 else -1)
    return Split(_i32(tiles[grp], tiles[grp + 1], steps[run],
                      steps[run + 1]),
                 *_tree([ngroups] if ngroups > 1 else []),
                 writes=writes.astype(np.int32))


def tile_stream_order(vals: np.ndarray, block: int, accumulate: bool,
                      c: np.ndarray, split: Split) -> np.ndarray:
    """:func:`tile_stream`'s kernel stated in numpy f32, in its order: each
    chunk adds its tiles to 0 in tile order; an output in one chunk is that
    sum + c; a split output's node adds its slots to 0 in order, and the
    output is the node's sum + c, or the nodes added to 0 in order + c.
    Every operation is one f32 add, so this is the kernel's result bit for
    bit."""
    v = np.asarray(vals, np.float32).reshape(-1, WINDOW)
    cv = np.asarray(c, np.float32).reshape(WINDOW)
    nsteps = v.shape[0] // block
    out = np.zeros((1 if accumulate else nsteps, WINDOW), np.float32)
    part = np.zeros((split.nslots, WINDOW), np.float32)
    dest = {}
    for lo, hi, slot, o in split.chunks.tolist():
        acc = np.zeros(WINDOW, np.float32)
        for t in range(lo, hi):
            acc = acc + v[t]
            if not accumulate and slot < 0 and (t + 1) % block == 0:
                out[t // block] = acc + cv
                acc = np.zeros(WINDOW, np.float32)
        if slot >= 0:
            part[slot] = acc
            dest[int(split.slot_out[slot])] = o
        elif accumulate:
            out[o] = acc + cv
    for k, o in dest.items():
        s0, s1 = int(split.slot_ptr[k]), int(split.slot_ptr[k + 1])
        nodes = []
        for a in range(s0, s1, REDUCE_FAN):
            acc = np.zeros(WINDOW, np.float32)
            for i in range(a, min(a + REDUCE_FAN, s1)):
                acc = acc + part[i]
            nodes.append(acc)
        acc = nodes[0]
        if len(nodes) > 1:
            acc = np.zeros(WINDOW, np.float32)
            for nd in nodes:
                acc = acc + nd
        out[o] = acc + cv
    return out.reshape((SUB, LANES) if accumulate else (nsteps, SUB, LANES))


#: device copies of split tables with their scratch, by key
_TABLES: Dict[tuple, tuple] = {}


def _on_device(key: tuple, anchor, make, stamp=None) -> SimpleNamespace:
    """The tables ``make()`` gives (a :class:`Split` and its device),
    placed once and kept under ``key``: their int32 tables, the partial
    sums' scratch (slots, then nodes, 1024 f32 each) and the tickets
    (zeros; each launch leaves them 0).  The key holds the CUDA stream the
    launch goes to, so launches on two streams never share a set.  With
    an ``anchor`` tensor the entry lives while it does (the key holds its
    id); an entry made under another ``stamp`` is made anew."""
    hit = _TABLES.get(key)
    if (hit is not None and (hit[0] is None or hit[0]() is anchor)
            and hit[1] == stamp):
        return hit[2]
    sp, dev = make()

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
    tabs = SimpleNamespace(
        split=sp, chunks=put(sp.chunks), slot_out=put(sp.slot_out),
        slot_ptr=put(sp.slot_ptr), node_ptr=put(sp.node_ptr),
        runs=None if sp.runs is None else put(sp.runs),
        zero_groups=None if sp.zero_groups is None else put(sp.zero_groups),
        writes=None if sp.writes is None else put(sp.writes),
        partial=torch.empty((sp.nslots + sp.nnodes) * WINDOW,
                            dtype=torch.float32, device=dev),
        tickets=torch.zeros(max(sp.ntickets, 1), dtype=torch.int32,
                            device=dev))
    for k in [k for k, (ref, _s, _t) in _TABLES.items()
              if ref is not None and ref() is None]:
        del _TABLES[k]
    _TABLES[key] = (None if anchor is None else weakref.ref(anchor), stamp,
                    tabs)
    return tabs


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy where its data is not 16-B aligned (16-B loads and
    bulk copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


# -- tile_stream (P1, P3, P7) -------------------------------------------------

def tile_stream_plain(vals: torch.Tensor, block: int, accumulate: bool,
                      c: torch.Tensor) -> torch.Tensor:
    """The first ``ntiles // block * block`` tiles summed: with
    ``accumulate`` ``c`` plus all of them, (8, 128); else ``c`` plus each
    step's ``block`` tiles, (nsteps, 8, 128)."""
    nsteps = vals.shape[0] // block
    v = vals[:nsteps * block]
    if accumulate:
        return c + v.sum(0)
    return v.view(nsteps, block, SUB, LANES).sum(1) + c


def tile_stream(vals: torch.Tensor, block: int, accumulate: bool,
                c: torch.Tensor,
                ticket: Optional[torch.Tensor] = None) -> torch.Tensor:
    """P1/P3/P7's stream: :func:`tile_stream_plain` as a kernel.  ``vals``
    (ntiles, 8, 128) f32, ``c`` (8, 128) f32.  The tiles are cut into
    chunks by :func:`stream_split` and summed in the fixed order that
    :func:`tile_stream_order` states, so every launch gives the same bits;
    ``ticket`` (int32 zeros, at least the split's ``ntickets``, which each
    launch leaves 0) may be kept by the caller across launches, else the
    one kept with the split's tables for the current CUDA stream is
    used."""
    if not _on_card("tile_stream", vals, c):
        return tile_stream_plain(vals, block, accumulate, c)
    if (vals.dtype != torch.float32 or c.dtype != torch.float32
            or tuple(vals.shape[1:]) != (SUB, LANES)
            or tuple(c.shape) != (SUB, LANES) or block < 1):
        raise ValueError("tile_stream: f32 (ntiles, 8, 128) tiles, an f32 "
                         "(8, 128) carry and block >= 1")
    dev = vals.device
    nsteps = vals.shape[0] // block
    if nsteps == 0:
        return (c.clone() if accumulate else
                torch.empty(0, SUB, LANES, dtype=torch.float32, device=dev))
    nsm = sm_count(dev)
    tabs = _on_device(
        ("stream", nsteps, block, bool(accumulate), nsm, dev, _stream(dev)),
        None, lambda: (stream_split(nsteps, block, accumulate, nsm), dev))
    sp = tabs.split
    if ticket is None:
        ticket = tabs.tickets
    elif ticket.dtype != torch.int32 or ticket.numel() < sp.ntickets:
        raise ValueError(f"tile_stream: ticket must hold {sp.ntickets} "
                         "int32 zeros")
    out = torch.empty((SUB, LANES) if accumulate else (nsteps, SUB, LANES),
                      dtype=torch.float32, device=dev)
    lib = _build.load_kernels()
    err = lib.spmv_probe_tile_stream(
        _aligned(vals).data_ptr(), _aligned(c).data_ptr(), out.data_ptr(),
        tabs.chunks.data_ptr(), tabs.slot_out.data_ptr(),
        tabs.slot_ptr.data_ptr(), tabs.node_ptr.data_ptr(),
        tabs.partial.data_ptr(), ticket.data_ptr(), len(sp.chunks),
        sp.nslots, sp.nnodes, block, int(accumulate), _stream(dev))
    _build.check(lib, err, "tile_stream")
    _count("tile_stream")
    return out


# -- tile_body (P2, P4, P5) ---------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BodyStream:
    """The inputs of one :func:`tile_body` run: G tiles a step."""

    meta: torch.Tensor            # (ntiles, 8, 128) int16
    vals: Optional[torch.Tensor]  # (ntiles, 8, 128) f32 or bf16, or None
    palette: torch.Tensor         # (128,) f32
    tinfo: torch.Tensor           # (ntiles,) int32: window << 3 | row
    ginfo: torch.Tensor           # (nsteps,) int32: group << 1 | first
    x: torch.Tensor               # f32, every window read
    g: int
    ngroups: int
    value_mode: str               # a key of BODY_VALUES
    gather: str = "full"          # a key of BODY_GATHERS
    mask: bool = True
    fixed_window: bool = False

    @property
    def ntiles(self) -> int:
        return self.meta.shape[0]


def _body_rows(b: BodyStream) -> torch.Tensor:
    """Each tile's addition to its output block, (ntiles, 8, 128), without
    init (:func:`tile_body_plain`)."""
    nt, dev = b.ntiles, b.meta.device
    m = b.meta.view(nt, SUB, LANES).to(torch.int64) & 0xFFFF
    lane = torch.arange(LANES, device=dev)
    r = m & 127
    if b.gather == "full":
        col = ((torch.gather(m, 2, r) >> 7) & 7) * LANES + r
    elif b.gather == "no_dim1":
        col = ((m >> 7) & 7) * LANES + lane
    else:
        col = (torch.arange(SUB, device=dev)[:, None] * LANES
               + lane).expand(nt, SUB, LANES)
    ti = b.tinfo.to(torch.int64)
    w = torch.zeros_like(ti) if b.fixed_window else ti >> 3
    xg = b.x[w[:, None, None] * WINDOW + col]
    if b.value_mode == "palette":
        v = b.palette[(m >> 10) & 63]
    elif b.value_mode == "dyadic":
        v = ((m >> 10) & 7).to(torch.float32) * 0.125
    else:
        v = b.vals.to(torch.float32)
    contrib = (v * xg).sum(1)                         # (nt, 128)
    if not b.mask:
        return contrib[:, None, :].expand(nt, SUB, LANES)
    rows = torch.zeros(nt, SUB, LANES, dtype=torch.float32, device=dev)
    rows[torch.arange(nt, device=dev), ti & 7] = contrib
    return rows


def tile_body_plain(b: BodyStream, init: torch.Tensor) -> torch.Tensor:
    """The body's sums, (ngroups, 8, 128): for each tile t (window
    ``tinfo >> 3``, or 0 with ``fixed_window``; row ``tinfo & 7``) and lane
    j, contrib = Σ_i value(i, j) · xg(i, j), with xg = x[1024 w + 128 s +
    r], r = meta & 127 at the slot and s = (meta >> 7) & 7 read at the cell
    (i, r) (``no_dim1``: s at the slot and the lane's own column;
    ``none``: x[1024 w + 128 i + j]); contrib goes into row ``row`` of the
    step's output block (every row without ``mask``), and the first step of
    a block adds ``init``."""
    dev = b.meta.device
    gi = b.ginfo.to(torch.int64)
    out = torch.zeros(b.ngroups, SUB, LANES, dtype=torch.float32,
                      device=dev)
    out.index_add_(0, (gi >> 1).repeat_interleave(b.g), _body_rows(b))
    first = (gi >> 1)[(gi & 1) == 1]
    return out.index_add_(0, first, init.view(1, SUB, LANES)
                          .expand(len(first), SUB, LANES))


def tile_body(b: BodyStream, init: torch.Tensor) -> torch.Tensor:
    """P2/P4/P5's body: :func:`tile_body_plain` as a kernel over the chunks
    and runs of :func:`body_split` (tables kept while ``b.ginfo`` lives
    and made anew once it is written in place), each group's pieces summed
    in a fixed order, so every launch gives the same bits."""
    ts = [t for t in (b.meta, b.vals, b.palette, b.tinfo, b.ginfo, b.x,
                      init) if t is not None]
    if not _on_card("tile_body", *ts):
        return tile_body_plain(b, init)
    if (b.value_mode not in BODY_VALUES or b.gather not in BODY_GATHERS
            or b.meta.dtype != torch.int16
            or b.ntiles != b.ginfo.numel() * b.g
            or (b.value_mode in ("f32", "bf16") and b.vals is None)):
        raise ValueError("tile_body: int16 meta of nsteps * g tiles, a "
                         "known value mode and gather, and values for "
                         "f32/bf16")
    dev = b.meta.device
    out = torch.empty(b.ngroups, SUB, LANES, dtype=torch.float32,
                      device=dev)
    if b.ntiles == 0:
        return out.zero_()
    nsm = sm_count(dev)
    # ginfo's pointer and version counter: a ginfo written in place since
    # the tables were made gets new ones
    tabs = _on_device(
        ("body", id(b.ginfo), b.g, b.ngroups, nsm, dev, _stream(dev)),
        b.ginfo,
        lambda: (body_split(b.ginfo.cpu().numpy(), b.g, b.ngroups, nsm),
                 dev), stamp=(b.ginfo.data_ptr(), b.ginfo._version))
    sp = tabs.split
    vals = None if b.value_mode in ("palette", "dyadic") else b.vals
    lib = _build.load_kernels()
    err = lib.spmv_probe_tile_body(
        _aligned(b.meta).data_ptr(),
        None if vals is None else _aligned(vals).data_ptr(),
        b.palette.data_ptr(), b.tinfo.data_ptr(), b.ginfo.data_ptr(),
        b.x.data_ptr(), init.data_ptr(), out.data_ptr(),
        tabs.chunks.data_ptr(), tabs.runs.data_ptr(),
        tabs.zero_groups.data_ptr(), tabs.slot_out.data_ptr(),
        tabs.slot_ptr.data_ptr(), tabs.node_ptr.data_ptr(),
        tabs.partial.data_ptr(), tabs.tickets.data_ptr(), len(sp.chunks),
        len(sp.zero_groups), sp.nslots, sp.nnodes, b.g,
        BODY_VALUES[b.value_mode], BODY_GATHERS[b.gather], int(b.mask),
        int(b.fixed_window), _stream(dev))
    _build.check(lib, err, "tile_body")
    _count("tile_body")
    return out


# -- window_gather (P9) -------------------------------------------------------

def window_gather_plain(wide: bool, a0, a1, a2, x) -> torch.Tensor:
    """Σ over the g tiles of the gathered (8, 128) tile.  Loop form (a0
    sidx, a1 ridx, a2 wsel; x window-major, 8 windows): for window j,
    x[(8 j + s(i, r)) · 128 + r] with r = ridx and s read at the cell
    (i, r), selected where wsel == j.  Wide form (a0 ctab, a1 srow; x the
    (8, 1024) bundle): x[srow][ctab(srow, l)]."""
    if wide:
        col = torch.gather(a0.to(torch.int64), 1, a1.to(torch.int64))
        xg = x.reshape(-1)[a1.to(torch.int64) * (P9_NW * LANES) + col]
        return xg.sum(0)
    r = a1.to(torch.int64)
    s = torch.gather(a0.to(torch.int64), 2, r)
    xf = x.reshape(-1)
    xg = torch.zeros(a0.shape, dtype=torch.float32, device=x.device)
    for j in range(P9_NW):
        xg = torch.where(a2 == j, xf[(j * SUB + s) * LANES + r], xg)
    return xg.sum(0)


def window_gather_order(wide: bool, a0, a1, a2, x,
                        split: Split) -> np.ndarray:
    """:func:`window_gather`'s kernel stated in numpy f32, in its order:
    each writing chunk adds its tiles' gathered slots to 0 in tile order;
    with one group that is the output, else the groups' slots are added
    to 0 in order by nodes of :data:`REDUCE_FAN`, and the nodes, where
    there are several, to 0 in order.  Every operation is one f32 add, so
    this is the kernel's result bit for bit (the steps repeat it).  Each
    slot gathers at the column the kernel computes: x[(8 wsel + s(i, r)) ·
    128 + r] (loop form), x[srow · 1024 + ctab(srow, l)] (wide)."""
    a0, a1 = np.asarray(a0, np.int64), np.asarray(a1, np.int64)
    xf = np.asarray(x, np.float32).reshape(-1)
    if wide:
        col = a1 * (P9_NW * LANES) + np.take_along_axis(a0, a1, 1)
    else:
        s = np.take_along_axis(a0, a1, 2)
        col = (SUB * np.asarray(a2, np.int64) + s) * LANES + a1
    xg = xf[col]
    sums = {}
    for (lo, hi, _s0, _s1), w in zip(split.chunks.tolist(),
                                     split.writes.tolist()):
        if w == -2:
            continue
        acc = np.zeros((SUB, LANES), np.float32)
        for t in range(lo, hi):
            acc = acc + xg[t]
        sums[w] = acc
    if -1 in sums:
        return sums[-1]
    s1 = int(split.slot_ptr[1])
    nodes = []
    for a in range(0, s1, REDUCE_FAN):
        acc = np.zeros((SUB, LANES), np.float32)
        for i in range(a, min(a + REDUCE_FAN, s1)):
            acc = acc + sums[i]
        nodes.append(acc)
    if len(nodes) == 1:
        return nodes[0]
    acc = np.zeros((SUB, LANES), np.float32)
    for nd in nodes:
        acc = acc + nd
    return acc


def window_gather(wide: bool, a0, a1, a2, x, nsteps: int) -> torch.Tensor:
    """P9's gather as a kernel: :func:`window_gather_plain`, with every one
    of the ``nsteps · g`` (step, tile) gathers done, as the TPU probe's
    ``nsteps`` grid steps over the same g tiles do.  The chunks of
    :func:`gather_split` each gather their tiles over their steps from x
    and index planes staged in shared memory; the g tiles' sum is taken in
    a fixed order (a group's tiles in order, then the groups in order), so
    every launch gives the same bits.  Index planes are (g, 8, 128) int32
    (a2 is not read in the wide form), x 8 windows of f32."""
    ts = [t for t in (a0, a1, a2, x) if t is not None]
    if not _on_card("window_gather", *ts):
        return window_gather_plain(wide, a0, a1, a2, x)
    planes = (a0, a1) if wide else (a0, a1, a2)
    if (any(t is None or t.dtype != torch.int32
            or t.dim() != 3 or tuple(t.shape) != tuple(a0.shape)
            or tuple(t.shape[1:]) != (SUB, LANES) for t in planes)
            or x.dtype != torch.float32 or x.numel() != P9_NW * WINDOW):
        raise ValueError("window_gather: int32 (g, 8, 128) index planes "
                         "(three in the loop form) and an f32 x of 8 "
                         "windows")
    dev = x.device
    nsm = sm_count(dev)
    g = a0.shape[0]
    tabs = _on_device(("gather", g, nsteps, nsm, dev, _stream(dev)), None,
                      lambda: (gather_split(g, nsteps, nsm), dev))
    sp = tabs.split
    out = torch.empty(SUB, LANES, dtype=torch.float32, device=dev)
    lib = _build.load_kernels()
    err = lib.spmv_probe_window_gather(
        *(_aligned(t).data_ptr() for t in planes[:2]),
        None if wide else _aligned(a2).data_ptr(), _aligned(x).data_ptr(),
        out.data_ptr(), tabs.chunks.data_ptr(), tabs.writes.data_ptr(),
        tabs.slot_out.data_ptr(), tabs.slot_ptr.data_ptr(),
        tabs.node_ptr.data_ptr(), tabs.partial.data_ptr(),
        tabs.tickets.data_ptr(), len(sp.chunks), sp.nslots, sp.nnodes,
        int(wide), _stream(dev))
    _build.check(lib, err, "window_gather")
    _count("window_gather")
    return out


# -- tiny (P6) and fma_err (P8) -----------------------------------------------

def tiny_plain(v: torch.Tensor) -> torch.Tensor:
    return v * 2.0


def _tiny_input(v: torch.Tensor) -> torch.Tensor:
    if v.dtype != torch.float32 or v.numel() != WINDOW:
        raise ValueError("tiny: one f32 (8, 128) tile")
    return _aligned(v)


def tiny(v: torch.Tensor) -> torch.Tensor:
    """P6: one (8, 128) f32 tile times 2, one launch with programmatic
    dependent launch (``csrc/probes.cu`` ``pdl_launch``)."""
    if not _on_card("tiny", v):
        return tiny_plain(v)
    v = _tiny_input(v)
    out = torch.empty_like(v)
    lib = _build.load_kernels()
    err = lib.spmv_probe_tiny(v.data_ptr(), out.data_ptr(),
                              _stream(v.device))
    _build.check(lib, err, "tiny")
    _count("tiny")
    return out


def tiny_chain_plain(v: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` applications of :func:`tiny_plain`: v·2ⁿ, exact in f32 while
    no value overflows (n ≤ 100 for normal inputs of magnitude < 2²⁷)."""
    for _ in range(n):
        v = tiny_plain(v)
    return v


def tiny_chain(v: torch.Tensor, n: int, pdl: bool = True) -> torch.Tensor:
    """P6 as the TPU probe times it, a loop of dependent launches with no
    host work between them: ``n`` launches of ``tiny`` from one C call
    (``spmv_probe_tiny_chain``), v → a, then a ↔ b, with programmatic
    dependent launch when ``pdl``.  Counts ``n`` launches of ``tiny``."""
    if not _on_card("tiny_chain", v):
        return tiny_chain_plain(v, n)
    v = _tiny_input(v)
    if n < 1:
        raise ValueError("tiny_chain: at least one launch")
    a, b = torch.empty_like(v), torch.empty_like(v)
    lib = _build.load_kernels()
    err = lib.spmv_probe_tiny_chain(v.data_ptr(), a.data_ptr(),
                                    b.data_ptr(), n, int(pdl),
                                    _stream(v.device))
    _build.check(lib, err, "tiny_chain")
    _count("tiny", n)
    return a if n % 2 else b


def fma_err_plain(a, b, p) -> torch.Tensor:
    """a·b − p in f64, rounded to f32: exact when p = fl(a·b) (the error
    of an f32 product is an f32)."""
    return (a.double() * b.double() - p.double()).float()


def fma_err(a, b, p) -> torch.Tensor:
    """P8: a·b − p a slot by one fused multiply-add (``__fmaf_rn``), one
    launch with programmatic dependent launch."""
    if not _on_card("fma_err", a, b, p):
        return fma_err_plain(a, b, p)
    if any(t.dtype != torch.float32 or t.shape != a.shape
           for t in (a, b, p)):
        raise ValueError("fma_err: three f32 tensors of one shape")
    e = torch.empty_like(a)
    lib = _build.load_kernels()
    err = lib.spmv_probe_fma_err(a.data_ptr(), b.data_ptr(), p.data_ptr(),
                                 e.data_ptr(), a.numel(), _stream(a.device))
    _build.check(lib, err, "fma_err")
    _count("fma_err")
    return e


# -- the probes ---------------------------------------------------------------

def _times(step, x0, iters: int = 10, repeats: int = 3):
    """(best ms, every repeat's ms) a call of ``step`` chained from x0."""
    s = timing.time_op_samples(step, x0, iters=iters, repeats=repeats)
    ms = [t * 1e3 for t in s]
    return min(ms), ms


#: bytes :func:`flush_l2` rewrites: well past the H100's 50 MB L2
FLUSH_BYTES = 256 << 20
_flush_bufs: Dict[torch.device, torch.Tensor] = {}


def flush_l2(device) -> None:
    """Rewrite :data:`FLUSH_BYTES` of scratch on the card ``device``
    (``bitwise_not`` in place), so that the next call finds nothing of its
    inputs in the L2: the flush behind every cold time here and in
    ``chip_smoke.py``.  The L2 is left holding dirty lines of the scratch,
    whose write-back shares device memory with the next call."""
    buf = _flush_bufs.get(device)
    if buf is None:
        buf = _flush_bufs[device] = torch.zeros(
            FLUSH_BYTES // 4, dtype=torch.int32, device=device)
    torch.bitwise_not(buf, out=buf)


def _cold_ms(step, x0, iters: int = 10) -> float:
    """The median ms of one call of ``step(x0)`` with the L2 cold: on the
    card, :func:`flush_l2` before each call, outside the CUDA events
    around it; on the CPU the host clock, nothing flushed."""
    dev = x0.device
    step(x0)
    timing.synchronize(dev)
    ms = []
    for _ in range(iters):
        if dev.type == "cuda":
            flush_l2(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step(x0)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            step(x0)
            ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def probe_inputs(a):
    """The probes' packs of ``a`` (theirs: clustered(200_000, 200_000, 32,
    spread=512, seed=9)), as the JAX probes make them:
    ``pack_sell8w(a, max_pad_ratio=3.0)`` and ``plan_v2(..., g=16)`` with a
    zero palette where the values have none (``probe4_body.py``)."""
    from ..formats.sell8w import pack_sell8w, plan_v2
    packed = pack_sell8w(a, max_pad_ratio=3.0)
    v2 = plan_v2(packed, g=16)
    if v2.palette is None:
        v2 = dataclasses.replace(v2, palette=np.zeros(128, np.float32))
    return a, packed, v2


def _dev(arr, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device) if dtype is None else t.to(device, dtype)


#: (name, block, accumulate) of every stream the probes give
#: :func:`tile_stream`
STREAM_INPUTS = (("P1 S_big", 64, True), ("P1 S_tile, P7 1", 1, True),
                 ("P1 S_tile8, P7 8", 8, True), ("P1 S_nodep", 8, False),
                 ("P3 B_huge512", 512, True))


def probe_stream(vals: torch.Tensor) -> List[dict]:
    """P1 (``make_stream_fn``): S_big (64 tiles a step), S_tile (1),
    S_tile8 (8), accumulated into a carry, and S_nodep (8, one sum a
    step); beside each chained time (``ms``, ``gbs``) one call's with the
    L2 cold (``cold_ms``, ``cold_gbs``)."""
    recs = []
    c0 = torch.ones(SUB, LANES, dtype=torch.float32, device=vals.device)
    for name, block, acc in (("S_big", 64, True), ("S_tile", 1, True),
                             ("S_tile8", 8, True), ("S_nodep", 8, False)):
        nt = vals.shape[0] // block * block
        if acc:
            def step(c, block=block):
                return tile_stream(vals, block, True, c)
        else:
            def step(c, block=block):
                return tile_stream(vals, block, False, c)[0]
        ms, all_ms = _times(step, c0)
        cold = _cold_ms(step, c0)
        recs.append({"variant": name, "ms": ms,
                     "gbs": nt * WINDOW * 4 / ms / 1e6, "all_ms": all_ms,
                     "cold_ms": cold, "cold_gbs": nt * WINDOW * 4 / cold
                     / 1e6})
    return recs


def probe_huge(vals: torch.Tensor) -> dict:
    """P3 (``pallas_huge``): the carried stream sum at 512 tiles a step,
    chained and (``cold_*``) one call with the L2 cold."""
    nt = vals.shape[0] // 512 * 512

    def step(c):
        return tile_stream(vals, 512, True, c)
    c0 = torch.ones(SUB, LANES, dtype=torch.float32, device=vals.device)
    ms, all_ms = _times(step, c0)
    cold = _cold_ms(step, c0)
    return {"variant": "B_huge512", "ms": ms,
            "gbs": nt * WINDOW * 4 / ms / 1e6, "all_ms": all_ms,
            "cold_ms": cold, "cold_gbs": nt * WINDOW * 4 / cold / 1e6}


def probe_step(vals: torch.Tensor) -> List[dict]:
    """P7 (``tile_stream_time``): the carried stream sum at 1 and 8 tiles a
    step, from a zero carry."""
    recs = []
    for block in (1, 8):
        ms, _all = _times(
            lambda c, block=block: tile_stream(vals, block, True, c),
            torch.zeros(SUB, LANES, dtype=torch.float32, device=vals.device))
        recs.append({"acc_block": block, "ms": ms,
                     "gbs": vals.numel() * 4 / ms / 1e6})
    return recs


def _x_ones(n: int, device) -> torch.Tensor:
    """``probe*.py``'s x0: ones over n padded to whole windows."""
    return torch.ones(-(-n // WINDOW) * WINDOW, dtype=torch.float32,
                      device=device)


def _fake_ginfo(nsteps: int, ngroups: int) -> np.ndarray:
    """``v2_proto``'s and ``build``'s per-step info: a monotone fake group
    ``step · ngroups // nsteps`` << 1 | first."""
    sg = (np.arange(nsteps) * ngroups // max(nsteps, 1)).astype(np.int64)
    first = np.ones(nsteps, np.int64)
    first[1:] = (sg[1:] != sg[:-1]).astype(np.int64)
    return (sg << 1 | first).astype(np.int32)


def g8_stream(packed, device, G: int = 8) -> BodyStream:
    """``make_g8_fn``'s inputs: G tiles a step, the window of each step's
    first tile, row k & 7 for the k-th tile of a step, one output block."""
    nt = packed.ntiles // G * G
    t = np.arange(nt)
    wid = np.asarray(packed.window_ids[:nt:G], np.int64)
    tinfo = (np.repeat(wid, G) << 3 | ((t % G) & 7)).astype(np.int32)
    ginfo = np.zeros(nt // G, np.int32)
    ginfo[0] = 1
    return BodyStream(
        meta=_dev(packed.meta[:nt], device),
        vals=_dev(packed.vals[:nt], device, torch.float32),
        palette=torch.zeros(LANES, dtype=torch.float32, device=device),
        tinfo=_dev(tinfo, device), ginfo=_dev(ginfo, device),
        x=_x_ones(packed.n, device), g=G, ngroups=1, value_mode="f32")


def probe_g8(packed, nnz: int, device) -> dict:
    """P2 (``make_g8_fn``): the v1 body at 8 tiles a step."""
    b = g8_stream(packed, device)
    ms, all_ms = _times(lambda c: tile_body(b, c)[0],
                        torch.ones(SUB, LANES, dtype=torch.float32,
                                   device=device))
    return {"variant": "G8", "ms": ms, "equiv_gflops": 2 * nnz / ms / 1e6,
            "all_ms": all_ms}


def v2proto_stream(packed, mode: str, device, G: int = 16) -> BodyStream:
    """``v2_proto``'s inputs: x resident, G tiles a step, each tile's own
    window and a fake row t & 7, fake monotone groups; ``mode`` "f32",
    "bf16" or "palette" (3-bit dyadic codes t & 7 in meta bits 10-12)."""
    nt = packed.ntiles // G * G
    meta = packed.meta[:nt].astype(np.int32)
    if mode == "palette":
        meta = meta | ((np.arange(nt)[:, None, None] & 7) << 10)
    meta = (meta & 0xFFFF).astype(np.uint16).view(np.int16)
    vals = None
    if mode == "bf16":
        vals = _dev(_bf16.from_f32(packed.vals[:nt]).view(np.int16),
                    device).view(torch.bfloat16)
    elif mode == "f32":
        vals = _dev(packed.vals[:nt], device, torch.float32)
    tinfo = (np.asarray(packed.window_ids[:nt], np.int64) << 3
             | (np.arange(nt) & 7)).astype(np.int32)
    ngroups = -(-packed.nslices // SUB)
    return BodyStream(
        meta=_dev(meta, device), vals=vals,
        palette=torch.zeros(LANES, dtype=torch.float32, device=device),
        tinfo=_dev(tinfo, device),
        ginfo=_dev(_fake_ginfo(nt // G, ngroups), device),
        x=_x_ones(packed.n, device), g=G, ngroups=ngroups,
        value_mode="dyadic" if mode == "palette" else mode)


def probe_v2proto(packed, nnz: int, device) -> List[dict]:
    """P4 (``v2_proto``): the v2 body at G = 16 in f32, palette (dyadic)
    and bf16 values."""
    recs = []
    for mode in ("f32", "palette", "bf16"):
        b = v2proto_stream(packed, mode, device)
        ms, all_ms = _times(lambda c, b=b: tile_body(b, c)[0],
                            torch.ones(SUB, LANES, dtype=torch.float32,
                                       device=device))
        eq_nnz = nnz * b.ntiles / packed.ntiles
        recs.append({"variant": f"C_v2_{mode}", "ms": ms,
                     "equiv_gflops": 2 * eq_nnz / ms / 1e6,
                     "ntiles": b.ntiles, "all_ms": all_ms})
    return recs


#: P5's variants: (name, G)
BODY_VARIANTS = (("full", 16), ("dyadic", 16), ("no_dim1", 16),
                 ("no_gather", 16), ("no_mask", 16), ("no_ds", 16),
                 ("full", 64))


def body_stream(v2, variant: str, G: int, device) -> BodyStream:
    """``probe4_body.build``'s inputs: the plan_v2 stream's meta and tinfo,
    fake monotone groups, the palette decoded from meta bits 10-15, and the
    variant's part taken out."""
    nt = v2.ntiles // G * G
    ngroups = -(-v2.nslices // SUB)
    return BodyStream(
        meta=_dev(v2.meta[:nt], device), vals=None,
        palette=_dev(np.asarray(v2.palette, np.float32), device),
        tinfo=_dev(v2.tinfo[:nt], device),
        ginfo=_dev(_fake_ginfo(nt // G, ngroups), device),
        x=_x_ones(v2.n, device), g=G, ngroups=ngroups,
        value_mode="dyadic" if variant == "dyadic" else "palette",
        gather={"no_dim1": "no_dim1",
                "no_gather": "none"}.get(variant, "full"),
        mask=variant != "no_mask", fixed_window=variant == "no_ds")


def body_inputs(packed, v2, device) -> List[tuple]:
    """(name, stream) of every input the probes give :func:`tile_body`:
    P2's (G 8), P4's three value modes (G 16), P5's variants
    (:data:`BODY_VARIANTS`) and P5's full body at G 8 beside its G 16
    and 64."""
    out = [("P2 G8", g8_stream(packed, device))]
    out += [(f"P4 {m}", v2proto_stream(packed, m, device))
            for m in ("f32", "palette", "bf16")]
    out += [(f"P5 {v} G{g}", body_stream(v2, v, g, device))
            for v, g in BODY_VARIANTS + (("full", 8),)]
    return out


def probe_body(v2, device) -> List[dict]:
    """P5 (``probe4_body.build``): the palette body with one part taken
    out, and at G = 64."""
    recs = []
    for variant, G in BODY_VARIANTS:
        b = body_stream(v2, variant, G, device)
        ms, all_ms = _times(lambda c, b=b: tile_body(b, c)[0],
                            torch.zeros(SUB, LANES, dtype=torch.float32,
                                        device=device))
        recs.append({"variant": variant, "G": G, "ms": ms,
                     "ns_per_tile": ms * 1e6 / b.ntiles, "all_ms": all_ms})
    return recs


#: launches of one :func:`tiny_chain` call that :func:`chain_ms` times
CHAIN_LAUNCHES = 100
#: GPU clock cycles the card spins (``torch.cuda._sleep``) before each
#: timed chain, about 2.5 ms at the H100's 1.98 GHz: the host enqueues
#: the whole chain meanwhile (100 launches take it about 0.5 ms on the
#: H100's host, 3.9-5.1 µs a launch), so the events see the card's floor,
#: not the host's launch rate
CHAIN_HOLD_CYCLES = 5_000_000


def chain_ms(v: torch.Tensor, pdl: bool) -> dict:
    """ms a launch of one :func:`tiny_chain` call of
    :data:`CHAIN_LAUNCHES` launches: the best of 3 × 10 samples, each two
    CUDA events around one call with the card held first
    (:data:`CHAIN_HOLD_CYCLES`), over the launches; ``host_us``: the
    host's µs a launch inside the same calls (the C loop's
    ``cudaLaunchKernelEx``).  On the CPU the host clock around the plain
    loop, nothing held."""
    dev, n = v.device, CHAIN_LAUNCHES
    tiny_chain(v, n, pdl)
    timing.synchronize(dev)
    ms, host = [], []
    for _ in range(30):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(CHAIN_HOLD_CYCLES)
            start.record()
            t0 = time.perf_counter()
            tiny_chain(v, n, pdl)
            host.append(time.perf_counter() - t0)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end) / n)
        else:
            t0 = time.perf_counter()
            tiny_chain(v, n, pdl)
            host.append(time.perf_counter() - t0)
            ms.append(host[-1] * 1e3 / n)
    return {"ms": min(ms), "host_us": min(host) * 1e6 / n}


def probe_tiny(device, iters: int = 100) -> dict:
    """P6 (``tiny_pallas``): ms a launch over an eager chain of ``iters``
    dependent :func:`tiny` calls (``tiny_pallas_ms``, which
    :func:`calibrate` reads as ``launch_ns``: a stripe pays an eager call),
    beside the card's floor, one :func:`tiny_chain` call of
    :data:`CHAIN_LAUNCHES` launches from C without and with programmatic
    dependent launch (``tiny_chain_ms``, ``tiny_chain_pdl_ms``, and the
    host's µs a launch in them), and the host's µs of one eager call
    (``tiny_host_us``).  On the CPU every figure is the plain version's."""
    v = torch.ones(SUB, LANES, dtype=torch.float32, device=device)
    ms, all_ms = _times(tiny, v, iters=iters)
    plain, pdl = chain_ms(v, False), chain_ms(v, True)
    return {"tiny_pallas_ms": ms, "all_ms": all_ms,
            "tiny_chain_ms": plain["ms"], "tiny_chain_pdl_ms": pdl["ms"],
            "tiny_chain_host_us": plain["host_us"],
            "tiny_chain_pdl_host_us": pdl["host_us"],
            "tiny_host_us": timing.host_us(tiny, v)}


def probe_fma(device) -> dict:
    """P8 (``probe_fma``): is ``a·b − fl(a·b)`` the product's exact error?
    On the card it must be (one IEEE FMA); raises otherwise."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((SUB, LANES)).astype(np.float32)
    b = rng.standard_normal((SUB, LANES)).astype(np.float32)
    p = a * b
    e = fma_err(*(_dev(v, device) for v in (a, b, p))).cpu().numpy()
    true = a.astype(np.float64) * b.astype(np.float64) - p.astype(np.float64)
    e = e.astype(np.float64)
    rec = {"fused_exact": bool(np.array_equal(e, true)),
           "all_zero": not e.any(),
           "max_abs_err": float(np.abs(e - true).max())}
    if not rec["fused_exact"]:
        raise AssertionError(f"fma_err is not the exact product error: "
                             f"{rec}")
    return rec


def p9_arrays(g: int = 32, seed: int = 0):
    """``probe_wide_gather_r5.main``'s consistent instance: srow the
    identity, so the cell table C(i, l) is each slot's own column in the
    bundle; returns (loop arrays, wide arrays, x, the numpy oracle)."""
    rng = np.random.default_rng(seed)
    width = P9_NW * LANES
    x = rng.standard_normal(SUB * width).astype(np.float32)
    rng.integers(0, SUB, (g, SUB, LANES))       # the probe's unused srow
    cin = (rng.integers(0, SUB, (g, SUB, LANES)).astype(np.int32) * LANES
           + np.arange(LANES, dtype=np.int32)[None, None, :])
    srow_id = np.tile(np.arange(SUB, dtype=np.int32)[None, :, None],
                      (g, 1, LANES))
    gidx = srow_id.astype(np.int64) * width + cin
    w_id = (gidx // 1024).astype(np.int32)
    s_id = ((gidx // 128) % 8).astype(np.int32)
    r_id = (gidx % 128).astype(np.int32)
    return ((s_id, r_id, w_id), (cin, srow_id), x, x[gidx].sum(axis=0))


def probe_wide_gather(device, g: int = 32, nsteps: int = 2048) -> List[dict]:
    """P9 (``run``): the 8-window loop against one wide gather, g tiles a
    step over ``nsteps`` steps; each result against the numpy oracle."""
    loop, wide, x, oracle = p9_arrays(g)
    x_d = _dev(x, device)
    args = {"loop": (False, *(_dev(v, device) for v in loop), x_d),
            "wide": (True, *(_dev(v, device) for v in wide), None, x_d)}
    recs = []
    for name, (w, a0, a1, a2, xv) in args.items():
        y = window_gather(w, a0, a1, a2, xv, nsteps).cpu().numpy()

        def step(xx, w=w, a0=a0, a1=a1, a2=a2):
            window_gather(w, a0, a1, a2, xx, nsteps)
            return xx
        ms, _all = _times(step, xv)
        recs.append({"variant": name, "ms": ms,
                     "ns_per_tile": ms * 1e6 / (g * nsteps),
                     "max_err": float(np.abs(y - oracle).max())})
    return recs


# -- the real kernels' co-timings --------------------------------------------

def _stream_ns(packed, slot_mode: bool, x: torch.Tensor) -> dict:
    """ms a launch of the SELL kernel over ``packed`` (back to back, CUDA
    events on the card) and ns a tile."""
    from ..ops import sell as sell_ops
    st = sell_ops.prepare_sell(packed, x.device, slot_mode=slot_mode)
    xin = x[:st.n]

    def step(v):
        sell_ops.sell_spmv(st, v)
        return v
    ms, _all = _times(step, xin, iters=20)
    return {"ms": ms, "ntiles": int(packed.ntiles),
            "steps": int(packed.ntiles // packed.g),
            "ns": ms * 1e6 / packed.ntiles, "value_mode": packed.value_mode,
            "kernel": sell_ops.kernel_name(st)}


def _x_for(a, device) -> torch.Tensor:
    dt = torch.float64 if a.vals.dtype == np.float64 else torch.float32
    return torch.from_numpy(np.random.default_rng(0).standard_normal(a.n)
                            ).to(device, dt)


def slot_tiles(a, device, nws=(1, 2, 4, 8), **kw) -> Dict[int, dict]:
    """``probe_cell_w_r5``'s method: ``a`` packed as SELL-8D at each bundle
    width (cell_w where nw > 1, g auto, pad up to 96, spill up to 5%),
    each through the slot kernel: ns a tile."""
    from ..formats.sell8d import pack_sell8d
    x = _x_for(a, device)
    out = {}
    for nw in nws:
        pk, _rest = pack_sell8d(a, g="auto", max_pad_ratio=96.0,
                                max_spill=0.05, nw=nw, cell_w=nw > 1, **kw)
        out[nw] = _stream_ns(pk, True, x)
    return out


def row_tiles(a, device, force_value_mode=None) -> dict:
    """The row-mode kernel over ``a`` packed as SELL-8W v2 (an f64 ``a``
    as hi and lo packs, ``probe_df_costs``' double-float split): ns a
    tile."""
    from ..formats.sell8w import pack_sell8w, plan_v2
    from ..types import CsrMatrix
    packed = pack_sell8w(a, max_pad_ratio=3.0)
    lo = None
    if a.vals.dtype == np.float64:
        lo = pack_sell8w(CsrMatrix(
            a.m, a.n, a.rowptr, a.colidx,
            (a.vals - a.vals.astype(np.float32).astype(np.float64))
            .astype(np.float32))).vals
    v2 = plan_v2(packed, lo_tiles=lo, force_value_mode=force_value_mode)
    return _stream_ns(v2, False, _x_for(a, device))


def graph_light(a):
    """The webbase light part as the graph plan packs it (the fold entries
    appended where there are heavy rows), and the split."""
    from ..formats.graph import prepare_graph_split
    from ..handle import _append_fold_entries
    prep = prepare_graph_split(a)
    light = prep.light
    if prep.heavy is not None:
        light = _append_fold_entries(prep.light, prep.fold_rows,
                                     np.asarray(prep.light.vals).dtype)
    return light, prep


def step_solve(light, nw: int, device) -> dict:
    """``probe_webbase_r4e``'s two-point solve: the same light matrix
    through the slot kernel at g = 8 and g = 16 (ms, steps, tiles each)."""
    from ..formats.sell8d import pack_sell8d
    x = _x_for(light, device)
    out = {}
    for g in (8, 16):
        pk, _rest = pack_sell8d(light, max_pad_ratio=48.0, nw=nw, g=g,
                                cell_w=nw > 1)
        out[f"g{g}"] = _stream_ns(pk, True, x)
    return out


def graph_rest(a, prep, light, nw: int):
    """The straggler stream (rows, cols, vals) of ``a``'s graph plan as
    ``create_handle`` packs it (``handle._build_graph_plan``), the stream
    ``probe_webbase_r4b`` timed through the handle; where that plan has
    none, that of the light part packed at depth cap 1."""
    from ..handle import _build_graph_plan
    lp = _build_graph_plan(a, prep)["light"]
    if "rest_rows" in lp:
        return lp["rest_rows"], lp["rest_cols"], lp["rest_vals"]
    return long_rest(light, nw)


def long_rest(light, nw: int):
    """The straggler stream of the light part packed at depth cap 1: every
    nonzero past the first of its (row, bundle) group, a long stream."""
    from ..formats.sell8d import pack_sell8d
    return pack_sell8d(light, max_pad_ratio=float("inf"), nw=nw,
                       depth_cap=1, max_spill=1.0, cell_w=nw > 1)[1]


def _op_ns(fn, x, elements: int) -> float:
    """ns an element of ``fn(x)``, timed back to back."""
    def step(v):
        fn(v)
        return v
    ms, _all = _times(step, x, iters=20)
    return ms * 1e6 / max(elements, 1)


def rest_ns(rest, m: int, device, dtype) -> float:
    """``probe_webbase_r4b``'s straggler price: the handle's straggler
    stream (``handle.add_rest``) over ``rest`` = (rows, cols, vals) into a
    zero y of m rows, ns a nonzero."""
    from ..handle import _prepare_rest, add_rest
    rows, cols, vals = rest
    r = _prepare_rest(rows, cols, np.asarray(vals).astype(
        np.float64 if dtype == torch.float64 else np.float32), device)
    n = int(np.asarray(cols).max()) + 1
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(n)).to(
        device, dtype)
    y = torch.zeros(m, dtype=dtype, device=device)
    return _op_ns(lambda v: add_rest(r, v, y), x, len(rows))


def hub_ns(hub_cols, n: int, device) -> float:
    """The graph plan's hub gather ``cat([x, x[hub]])``, ns a hub column."""
    hub = torch.from_numpy(np.asarray(hub_cols, np.int64)).to(device)
    x = torch.ones(n, dtype=torch.float32, device=device)
    return _op_ns(lambda v: torch.cat([v, v[hub]]), x, len(hub))


def fold_ns(fold_rows, m: int, device) -> float:
    """The heavy rows' fold, one scatter-add of their outputs into y, ns a
    row."""
    fr = torch.from_numpy(np.asarray(fold_rows, np.int64)).to(device)
    y = torch.zeros(m, dtype=torch.float32, device=device)
    yh = torch.ones(len(fr), dtype=torch.float32, device=device)
    return _op_ns(lambda v: y.index_add_(0, fr, v), yh, len(fr))


def row_slice(a, rows: int):
    """The first ``rows`` rows of ``a``, every column kept."""
    from ..types import CsrMatrix
    rp = np.asarray(a.rowptr[:rows + 1])
    e = int(rp[-1])
    return CsrMatrix(rows, a.n, rp, a.colidx[:e], a.vals[:e])


def calibrate(mats: dict, device, probes: Optional[dict] = None) -> dict:
    """The named figures :func:`derive_prices` reads, on ``device``:

    * from the probes (``probes``, :func:`run_probes`' records): the launch
      (P6's eager chain, ``tiny_pallas_ms``; see :func:`derive_prices`);
      the stream ceiling, the best of P1/P3 with the L2 cold
      (``stream_gbs``), and beside it the best chained, warm figure
      (``stream_gbs_warm``, not read by the table); and beside the table
      P4's bf16 tile over its palette tile (``vals_ns_p4``, a
      cross-check).  The ceiling prices x bytes that a stripe or window
      reads from device memory, as the TPU's HBM figure did; a chained
      48 MB stream on the card is served partly from its 50 MB L2, so the
      warm figure is not that rate.  The cold figure is taken after
      :func:`flush_l2`, whose dirty lines are written back during the
      call: it holds that write-back too;
    * from the real kernels on ``mats``: ``uniform`` (f32) and
      ``uniform_f64`` at nw 1-8 (K1 slot, K2 slot df16; df at nw 8;
      ``vals_ns``: the nw = 4 pack forced to bf16 values over the same
      pack with its palette, the JAX package's method for ``_VALS_NS``),
      ``clustered`` and ``clustered_f64`` in row mode (K1 row, K2 row df16
      and df), ``wide`` (n > 2M) at nw 1-8 (K6), and ``webbase``: its
      light part at g 8 and 16 (the step solve), its graph plan's straggler
      stream (f32 and f64: what the handle pays a straggler, launches
      included), hub gather and fold; beside the table, the straggler
      price on :func:`long_rest`'s stream (``rest_ns_long``, f32).

    Returns ``{"figures": ..., "detail": ...}``."""
    from ..formats import prices as prices_mod
    probes = probes if probes is not None else run_probes(mats, device)
    p4 = {r["variant"]: r for r in probes["P4"]}
    stream = probes["P1"] + [probes["P3"]]
    detail = {"slot": slot_tiles(mats["uniform"], device),
              "slot_df16": slot_tiles(mats["uniform_f64"], device),
              "slot_df": slot_tiles(mats["uniform_f64"], device, nws=(8,),
                                    force_value_mode="df"),
              "slot_bf16": slot_tiles(mats["uniform"], device, nws=(4,),
                                      force_value_mode="bf16"),
              "slot_w": slot_tiles(mats["wide"], device),
              "row": row_tiles(mats["clustered"], device),
              "row_df16": row_tiles(mats["clustered_f64"], device),
              "row_df": row_tiles(mats["clustered_f64"], device,
                                  force_value_mode="df")}
    light, prep = graph_light(mats["webbase"])
    detail["step_solve"] = step_solve(light, prep.nw, device)
    detail["light_nw"] = prep.nw
    rest = graph_rest(mats["webbase"], prep, light, prep.nw)
    m = mats["webbase"].m
    figures = {
        "launch_ns": probes["P6"]["tiny_pallas_ms"] * 1e6,
        "stream_gbs": max(r["cold_gbs"] for r in stream),
        "stream_gbs_warm": max(r["gbs"] for r in stream),
        "vals_ns": detail["slot_bf16"][4]["ns"] - detail["slot"][4]["ns"],
        "vals_ns_p4": (p4["C_v2_bf16"]["ms"] - p4["C_v2_palette"]["ms"])
        * 1e6 / p4["C_v2_bf16"]["ntiles"],
        "step_solve": {k: {"ms": v["ms"], "steps": v["steps"],
                           "tiles": v["ntiles"]}
                       for k, v in detail["step_solve"].items()},
        "slot_ns": {w: v["ns"] for w, v in detail["slot"].items()},
        "slot_df16_ns": {w: v["ns"] for w, v in detail["slot_df16"].items()},
        "slot_df_ns": detail["slot_df"][8]["ns"],
        "slot_w_ns": {w: v["ns"] for w, v in detail["slot_w"].items()},
        "row_ns": detail["row"]["ns"], "row_df_ns": detail["row_df"]["ns"],
        "row_df16_ns": detail["row_df16"]["ns"],
        "rest_ns": rest_ns(rest, m, device, torch.float32),
        "rest_ns_df": rest_ns(rest, m, device, torch.float64),
        "hub_ns": hub_ns(prep.hub_cols, mats["webbase"].n, device),
        "fold_ns": fold_ns(prep.fold_rows, m, device)}
    figures["rest_nnz"] = len(rest[0])
    long = long_rest(light, prep.nw)
    figures["rest_ns_long"] = rest_ns(long, m, device, torch.float32)
    figures["rest_nnz_long"] = len(long[0])
    prices_mod.derive_prices(figures)       # every figure it needs is here
    return {"figures": figures, "detail": detail}


def run_probes(mats: dict, device) -> dict:
    """P1-P9 on ``mats["clustered"]`` (the JAX probes' clustered200k) and
    P9's own arrays: each probe's records under its JAX field names."""
    a, packed, v2 = probe_inputs(mats["clustered"])
    vals = _dev(packed.vals, device, torch.float32)
    return {"P1": probe_stream(vals), "P2": probe_g8(packed, a.nnz, device),
            "P3": probe_huge(vals),
            "P4": probe_v2proto(packed, a.nnz, device),
            "P5": probe_body(v2, device), "P6": probe_tiny(device),
            "P7": probe_step(vals), "P8": probe_fma(device),
            "P9": probe_wide_gather(device)}
