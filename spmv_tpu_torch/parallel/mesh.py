"""Multi-device SpMV over a 1-D mesh (the port of ``spmv_tpu/parallel/mesh.py``).

Rows (or, past 2M columns, columns) are split into one block a device, and
each block runs the single-device plan of its family: the tiled scan, DIA,
the v1 SELL-8W stream (K9, K10 for f64: ``ops/sell.py`` ``prepare_v1``) or
the SELL-8D slot stream (K1, K2).  The builders pack the same stacked
``(ndev, ...)`` numpy arrays as the JAX builders, padded to one length
across shards, and place shard d's arrays on ``mesh.devices[d]``.

On a mesh of one process (``Mesh.ranks`` None) the layer is
single-controller, as the JAX one is on one host: one process drives every
shard (the JAX package jits one ``shard_map``; here the shards run one
after another from Python).  Its collectives, in that one process:

* ``all_gather``: the shards' x blocks concatenated on each shard's device;
* the halo ring (``ppermute``): shard d reads the blocks ``(d-h .. d+h) mod
  ndev`` in that order, the window ``mesh.py``'s rings assemble;
* ``psum``: the partial outputs added in shard order on ``devices[0]``
  (f64 for the double-float modes).

Outputs come back to one y on ``devices[0]``.

A mesh that spans processes (``multihost.global_mesh_1d``: one controller a
``torch.distributed`` rank, ``Mesh.ranks`` naming each shard's rank) runs
the same plans: every rank builds the identical host pack (the builders are
deterministic) and places only the shards it owns; every rank passes the
whole x and gets the whole y on its first local device (``Mesh.home``).
The collectives become ``torch.distributed`` calls between the ranks, each
giving the bits the single-controller plan gives:

* ``all_gather``: each rank cuts its own x blocks and all-gathers them;
* the halo ring: point to point (``batch_isend_irecv``), a shard receiving
  only the blocks (DIA: the band edges) of its window that another rank
  owns, once a receiving rank; blocks of its own rank are read in place;
* the outputs: an all-gather of each rank's output blocks;
* ``psum``: an all-gather of the partials, added in shard order on every
  rank (not ``all_reduce``, whose order of addition is the backend's);
* the straggler streams, the hybrid's fold and the graph plan's hub
  gather: on every rank's home device, against its whole x and y.

NCCL carries the CUDA tensors themselves; gloo carries host tensors, so
under gloo the collectives copy each CUDA tensor to the host and back.
``sent_bytes`` counts what this process sends.
"""

from __future__ import annotations

import collections
import dataclasses
from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..formats import _bf16
from ..formats.partition import balanced_row_splitter
from ..formats.prices import Prices
from ..ops import sell as sell_ops
from ..ops import torch_csr
from ..types import CsrMatrix, INT_DTYPE, dtype_name
from ..utils.profiling import dev_put

__all__ = ["DistSpmvPlan", "build_dist_plan", "dist_spmv",
           "DistDiaPlan", "build_dist_dia_plan", "dist_dia_spmv",
           "DistSell8WPlan", "build_dist_sell8w_plan", "dist_sell8w_spmv",
           "DistSell8DPlan", "build_dist_sell8d_plan", "dist_sell8d_spmv",
           "DistSell8DColsPlan", "build_dist_sell8d_cols_plan",
           "dist_sell8d_cols_spmv",
           "DistAutoPlan", "build_dist_auto", "dist_auto_spmv",
           "make_mesh_1d"]

_X_MODES = ("replicated", "allgather", "halo")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: one torch device a shard (entries may repeat).

    ``ranks``: the ``torch.distributed`` rank that owns each shard, when the
    mesh spans the processes of the default group
    (``multihost.global_mesh_1d``); each rank owns as many shards, and
    ``devices`` holds each shard's device as its rank names it.  None: one
    process drives every shard."""

    devices: Tuple[torch.device, ...]
    axis: str = "rows"
    ranks: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.ranks is not None and (
                len(self.ranks) != len(self.devices)
                or len(set(collections.Counter(self.ranks).values())) != 1):
            raise ValueError(f"ranks {self.ranks} must name one rank a "
                             "device, each rank as many times")

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis: len(self.devices)}

    def owns(self, d: int) -> bool:
        """Whether this process drives shard d."""
        return self.ranks is None or self.ranks[d] == dist.get_rank()

    @property
    def home(self) -> torch.device:
        """Where x is taken and y returned: ``devices[0]`` in one process,
        the rank's first local device across processes."""
        if self.ranks is None:
            return self.devices[0]
        return self.devices[self.ranks.index(dist.get_rank())]


def make_mesh_1d(n_devices: Optional[int] = None, axis: str = "rows",
                 device=None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` CUDA devices (all of them by
    default); raises when there are none or too few.

    With ``device`` given, the mesh holds ``n_devices`` entries of that one
    device (one by default).  It exists for the reason the JAX package's
    tests set ``--xla_force_host_platform_device_count``: a mesh of any
    width on one device, so the sharded plans run on the CPU in tests and
    on one card."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return Mesh(tuple([dev] * (n_devices or 1)), axis)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = n_devices or count
    if count == 0 or n > count:
        raise RuntimeError(f"make_mesh_1d: {n or 'any'} CUDA devices asked "
                           f"for, {count} visible; pass device= for a mesh "
                           "of one repeated device")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis)


# --------------------------------------------------------------------------
# Placement and the collectives
# --------------------------------------------------------------------------

#: bytes this process has sent to other ranks through the collectives of a
#: multi-process mesh: a point-to-point slice once, an all-gather's
#: contribution once for each other rank
sent_bytes = 0


def _first(items):
    """The first shard entry this process holds."""
    return next(v for v in items if v is not None)


def _shards(mesh: Mesh, arr: np.ndarray, index: bool = False):
    """A stacked (ndev, ...) host array → shard d's slice on devices[d]
    (int64 for index arrays); None for the shards of other ranks."""
    return tuple(dev_put(arr[d].astype(np.int64) if index else arr[d], dev)
                 if mesh.owns(d) else None
                 for d, dev in enumerate(mesh.devices))


def _value_shards(mesh: Mesh, arr: np.ndarray):
    """A stacked (ndev, ...) value array → its shards (:func:`_shards`);
    bf16 bits (uint16, ``formats/_bf16.py``) become ``torch.bfloat16``."""
    arr = np.asarray(arr)
    return _shards(mesh, _bf16.as_torch(arr) if arr.dtype == np.uint16
                   else arr)


def _value_dtype(vals: torch.Tensor) -> torch.dtype:
    """The type x and y take beside values of ``vals``' type: f64 for
    f64, f32 for f32 and bf16 (summed in f32)."""
    return torch.float64 if vals.dtype == torch.float64 else torch.float32


def _x_in(mesh: Mesh, x, n: int, dtype: torch.dtype) -> torch.Tensor:
    """x as a contiguous ``dtype`` tensor on the home device; a numpy
    array is copied there."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    if tuple(x.shape) != (n,):
        raise ValueError(f"x has shape {tuple(x.shape)}, expected ({n},)")
    return x.to(device=mesh.home, dtype=dtype).contiguous()


def _pad(x: torch.Tensor, length: int) -> torch.Tensor:
    """Zero-pad x to ``length`` (even blocks for the sharded x modes)."""
    if length == x.numel():
        return x
    return torch.cat([x, x.new_zeros(length - x.numel())])


def _blocks(mesh: Mesh, x: torch.Tensor):
    """x sharded over the mesh: ndev equal blocks, block d on devices[d]
    (None where another rank owns it)."""
    nd = len(mesh.devices)
    return [b.to(dev) if mesh.owns(d) else None
            for d, (b, dev) in enumerate(zip(x.view(nd, -1), mesh.devices))]


def _wire(mesh: Mesh) -> torch.device:
    """The device a collective's tensors travel from: the home device
    under NCCL, which carries CUDA tensors; the host under gloo, which
    carries host tensors only (a CUDA block is copied there and back)."""
    return (torch.device("cpu") if dist.get_backend() == "gloo"
            else mesh.home)


def _gather(mesh: Mesh, parts):
    """Across processes: every shard's tensor in shard order, on the home
    device, from ``parts`` holding this rank's (one shape on every shard)
    and None elsewhere: one all-gather of each rank's tensors, stacked."""
    global sent_bytes
    wire = _wire(mesh)
    mine = torch.stack([p.to(wire) for p in parts if p is not None])
    got = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(got, mine)
    sent_bytes += mine.numel() * mine.element_size() * (len(got) - 1)
    got = [g.to(mesh.home) for g in got]
    seen = collections.Counter()
    out = []
    for r in mesh.ranks:
        out.append(got[r][seen[r]])
        seen[r] += 1
    return out


def _exchange(mesh: Mesh, blocks, wants):
    """For each shard d this process drives, the concatenation of the
    slices ``wants(d)`` = [(block, lo, hi), ...] of the x blocks on
    devices[d] (None for other ranks' shards): the halo windows.  In one
    process every block is at hand.  Across processes a slice of a block
    another rank owns comes from it point to point, once a receiving rank,
    as ``ppermute`` moves it, and a block of this rank is read in place;
    every rank lists the same moves in the same order, so sends and
    receives pair up (the tag is the move's index)."""
    global sent_bytes
    got = {}
    if mesh.ranks is not None:
        me, wire, ranks = dist.get_rank(), _wire(mesh), mesh.ranks
        moves = sorted({(b, lo, hi, ranks[b], ranks[d])
                        for d in range(len(ranks))
                        for b, lo, hi in wants(d) if ranks[b] != ranks[d]})
        like = _first(blocks)
        ops = []
        for tag, (b, lo, hi, src, dst) in enumerate(moves):
            if src == me:
                t = blocks[b][lo:hi].to(wire).contiguous()
                sent_bytes += t.numel() * t.element_size()
                ops.append(dist.P2POp(dist.isend, t, dst, tag=tag))
            elif dst == me:
                t = torch.empty(hi - lo, dtype=like.dtype, device=wire)
                got[b, lo, hi] = t
                ops.append(dist.P2POp(dist.irecv, t, src, tag=tag))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
    return [torch.cat([(got[b, lo, hi] if (b, lo, hi) in got
                        else blocks[b][lo:hi]).to(dev)
                       for b, lo, hi in wants(d)]) if mesh.owns(d)
            else None for d, dev in enumerate(mesh.devices)]


def _all_gather(blocks, dev) -> torch.Tensor:
    return torch.cat([b.to(dev) for b in blocks])


def _windows(mesh: Mesh, blocks, h: int):
    """Every shard's halo window: blocks (d-h .. d+h) mod ndev, in order
    (None for other ranks' shards)."""
    nd, size = len(blocks), _first(blocks).numel()
    return _exchange(mesh, blocks, lambda d: [
        ((d + k) % nd, 0, size) for k in range(-h, h + 1)])


def _assemble(mesh: Mesh, x: torch.Tensor, x_mode: str, halo: int, mr: int,
              n: int):
    """Each shard's x: x itself (replicated), the gathered blocks cut to n
    (allgather), or the halo window; None for other ranks' shards."""
    nd = len(mesh.devices)
    if x_mode == "allgather":
        blocks = _blocks(mesh, _pad(x, -(-n // nd) * nd))
        if mesh.ranks is None:
            return [_all_gather(blocks, dev)[:n] for dev in mesh.devices]
        xg = torch.cat(_gather(mesh, blocks))
        return [xg.to(dev)[:n] if mesh.owns(d) else None
                for d, dev in enumerate(mesh.devices)]
    if x_mode == "halo":
        return _windows(mesh, _blocks(mesh, _pad(x, mr * nd)), halo)
    return [x.to(dev) if mesh.owns(d) else None
            for d, dev in enumerate(mesh.devices)]


def _concat(mesh: Mesh, parts) -> torch.Tensor:
    """The shards' output blocks in shard order, on the home device."""
    if mesh.ranks is not None:
        parts = _gather(mesh, parts)
    return torch.cat([p.to(mesh.home) for p in parts])


def _psum(mesh: Mesh, parts) -> torch.Tensor:
    """The shards' partial outputs added in shard order on the home device.
    Across processes the partials are gathered and added in that same
    order on every rank, so every rank's y has the single-controller
    plan's bits (an ``all_reduce`` would add in the backend's order)."""
    if mesh.ranks is not None:
        parts = _gather(mesh, parts)
    y = parts[0].to(mesh.home)
    for p in parts[1:]:
        y = y + p.to(mesh.home)
    return y


def _place_rest(mesh: Mesh, rest):
    """A host (rows, cols, vals) straggler stream → (rows, cols, vals,
    the rows' fixed-order fold) on the home device (every rank's, across
    processes)."""
    if rest is None:
        return None
    dev = mesh.home
    rows, cols, vals = (np.asarray(r) for r in rest)
    if vals.dtype == np.uint16:                 # bf16 bits
        vals = _bf16.as_torch(vals)
    return (dev_put(rows.astype(np.int64), dev),
            dev_put(cols.astype(np.int64), dev), dev_put(vals, dev),
            torch_csr.fold_plan(rows, dev))


def _add_rest(y: torch.Tensor, rest, x: torch.Tensor) -> torch.Tensor:
    """y[rows] += vals · x[cols], in y's type; rows repeat, so the terms
    fold in a fixed order (:func:`torch_csr.fold_add`)."""
    if rest is None:
        return y
    _rows, cols, vals, fold = rest
    return torch_csr.fold_add(y, fold, vals * x[cols])


# --------------------------------------------------------------------------
# Row-sharded scan plan
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DistSpmvPlan:
    """Row-sharded SpMV plan: static metadata + each shard's tensors."""

    mesh: Mesh
    axis: str
    ndev: int
    m: int
    n: int
    nnz: int
    tile: int
    mr: int                      # padded rows per shard
    row_splitter: np.ndarray     # (ndev+1,) global row boundaries
    x_mode: str                  # "replicated" | "allgather" | "halo"
    # one tensor a shard, on its device:
    colidx_pad: tuple            # (L,) local col indices
    vals_pad: tuple              # (L,)
    row_start: tuple             # (mr,) positions into the padded stream
    row_end: tuple               # (mr,)
    out_index: Optional[torch.Tensor]  # (m,) gather from (ndev*mr,), or None
    identity_out: bool = False   # out_index is arange(m) → no gather
    # halo mode: the LOCAL stream (columns in the shard's own x block); the
    # main stream holds the remote nonzeros
    loc_colidx: Optional[tuple] = None
    loc_vals: Optional[tuple] = None
    loc_row_start: Optional[tuple] = None
    loc_row_end: Optional[tuple] = None
    loc_tile: int = 0
    halo: int = 0                # ring depth (halo mode)
    in_index: Optional[torch.Tensor] = None  # x → splitter-aligned blocks

    def __call__(self, x) -> torch.Tensor:
        return dist_spmv(self, x)

    @property
    def dtype(self) -> torch.dtype:
        """The type of x and y: f64 for f64 values, else f32."""
        return _value_dtype(_first(self.vals_pad))


def build_dist_plan(a: CsrMatrix, mesh: Mesh, axis: str = "rows",
                    tile: int = 2048, x_mode: str = "replicated",
                    halo_shards: int = 1) -> DistSpmvPlan:
    """Partition rows over the mesh (nnz-balanced) and place the shards.

    ``x_mode="halo"``: x is cut in blocks that follow the row split and
    each shard reads only its neighbours' blocks; the ring depth comes from
    the matrix (``halo_shards`` is a floor).  Raises ValueError when the
    columns reach so far that the ring would cover the whole mesh."""
    if x_mode not in _X_MODES:
        raise ValueError(f"unknown x_mode {x_mode!r}")
    ndev = mesh.shape[axis]
    if x_mode == "halo":
        return _place_scan(mesh, axis,
                           *_pack_scan_halo(a, ndev, tile, halo_shards))
    return _place_scan(mesh, axis, *_pack_scan(a, ndev, tile, x_mode))


def _out_index(splitter: np.ndarray, m: int, mr: int):
    owner = np.searchsorted(splitter, np.arange(m), side="right") - 1
    out_index = (owner * mr + (np.arange(m) - splitter[owner])) \
        .astype(INT_DTYPE)
    return owner, out_index, bool(np.array_equal(out_index, np.arange(m)))


def _pack_scan(a: CsrMatrix, ndev: int, tile: int, x_mode: str):
    splitter = balanced_row_splitter(a.rowptr, ndev).astype(np.int64)
    rowptr64 = a.rowptr.astype(np.int64)
    mr = max(int(np.max(splitter[1:] - splitter[:-1])), 1)
    shard_nnz = rowptr64[splitter[1:]] - rowptr64[splitter[:-1]]
    # +1 for the prepended zero (the inclusive scan becomes an exclusive
    # prefix), rounded to the tile; one length for every shard
    L = max(-(-(int(shard_nnz.max()) + 1) // tile) * tile, tile)
    colidx = np.zeros((ndev, L), dtype=INT_DTYPE)
    vals = np.zeros((ndev, L), dtype=a.vals.dtype)
    row_start = np.zeros((ndev, mr), dtype=INT_DTYPE)
    row_end = np.zeros((ndev, mr), dtype=INT_DTYPE)
    for d in range(ndev):
        r0, r1 = int(splitter[d]), int(splitter[d + 1])
        p0, p1 = int(rowptr64[r0]), int(rowptr64[r1])
        nr = r1 - r0
        colidx[d, 1: 1 + p1 - p0] = a.colidx[p0:p1]
        vals[d, 1: 1 + p1 - p0] = a.vals[p0:p1]
        # padded rows point at index 0 (start == end) → y = 0
        row_start[d, :nr] = (rowptr64[r0:r1] - p0).astype(INT_DTYPE)
        row_end[d, :nr] = (rowptr64[r0 + 1: r1 + 1] - p0).astype(INT_DTYPE)
    _owner, out_index, identity_out = _out_index(splitter, a.m, mr)
    static = dict(m=a.m, n=a.n, nnz=a.nnz, tile=tile, mr=mr,
                  row_splitter=splitter, x_mode=x_mode,
                  identity_out=identity_out, loc_tile=0, halo=0)
    return static, dict(colidx_pad=colidx, vals_pad=vals,
                        row_start=row_start, row_end=row_end,
                        out_index=out_index)


def _pack_scan_halo(a: CsrMatrix, ndev: int, tile: int, h_min: int):
    """The halo plan on the nnz-balanced row split: x blocks follow the
    split (padded to mr), the ring depth is the furthest block distance any
    shard's columns reach modulo ndev (the ring is circular), and each
    shard keeps a LOCAL stream (its own block) and a REMOTE one."""
    if a.m != a.n:
        raise ValueError("halo mode requires a square matrix")
    rowptr64 = a.rowptr.astype(np.int64)
    splitter = balanced_row_splitter(a.rowptr, ndev).astype(np.int64)
    mr = max(int(np.max(splitter[1:] - splitter[:-1])), 1)
    owner_of, out_index, identity_out = _out_index(splitter, a.m, mr)
    h = h_min
    for d in range(ndev):
        p0, p1 = int(rowptr64[splitter[d]]), int(rowptr64[splitter[d + 1]])
        if p1 > p0:
            own = owner_of[a.colidx[p0:p1]]
            fw = (own - d) % ndev
            h = max(h, int(np.minimum(fw, (ndev - fw) % ndev).max()))
    if 2 * h + 1 > ndev:
        raise ValueError(
            f"halo depth {h} needs {2 * h + 1} blocks > ndev={ndev}; "
            "columns reach too far — reorder for locality (cluster/rcm) "
            "or use x_mode='allgather'")
    loc_counts = np.zeros((ndev, mr), dtype=np.int64)
    rem_counts = np.zeros((ndev, mr), dtype=np.int64)
    loc_streams, rem_streams = [], []
    for d in range(ndev):
        r0, r1 = int(splitter[d]), int(splitter[d + 1])
        p0, p1 = int(rowptr64[r0]), int(rowptr64[r1])
        cols_d = a.colidx[p0:p1].astype(np.int64)
        vals_d = a.vals[p0:p1]
        own = owner_of[cols_d] if cols_d.size else cols_d
        is_loc = own == d
        rows_d = np.repeat(np.arange(r1 - r0),
                           np.diff(rowptr64[r0:r1 + 1]).astype(np.int64))
        np.add.at(loc_counts[d], rows_d[is_loc], 1)
        np.add.at(rem_counts[d], rows_d[~is_loc], 1)
        # position of block ``own`` in the window [d-h .. d+h], circular
        local = ((own - d + h) % ndev) * mr + (cols_d - splitter[own])
        loc_streams.append(((cols_d - splitter[d])[is_loc], vals_d[is_loc]))
        rem_streams.append((local[~is_loc], vals_d[~is_loc]))

    def _stack(streams, counts):
        ln = max(max((len(c) for c, _ in streams), default=0) + 1, 1)
        L = max(-(-ln // tile) * tile, tile)
        colidx = np.zeros((ndev, L), dtype=INT_DTYPE)
        vals = np.zeros((ndev, L), dtype=a.vals.dtype)
        row_start = np.zeros((ndev, mr), dtype=INT_DTYPE)
        row_end = np.zeros((ndev, mr), dtype=INT_DTYPE)
        for d, (c, v) in enumerate(streams):
            colidx[d, 1: 1 + len(c)] = c.astype(INT_DTYPE)
            vals[d, 1: 1 + len(v)] = v
            ends = np.cumsum(counts[d])
            row_start[d] = (ends - counts[d]).astype(INT_DTYPE)
            row_end[d] = ends.astype(INT_DTYPE)
        return colidx, vals, row_start, row_end

    colidx, vals, row_start, row_end = _stack(rem_streams, rem_counts)
    lcol, lval, lstart, lend = _stack(loc_streams, loc_counts)
    in_index = None
    if not identity_out:
        # x into splitter-aligned blocks (pads read x_pad[m] == 0)
        base = splitter[:-1, None] + np.arange(mr)[None, :]
        lens = (splitter[1:] - splitter[:-1])[:, None]
        in_index = np.where(np.arange(mr)[None, :] < lens, base,
                            a.m).reshape(-1).astype(INT_DTYPE)
    static = dict(m=a.m, n=a.n, nnz=a.nnz, tile=tile, mr=mr,
                  row_splitter=splitter, x_mode="halo",
                  identity_out=identity_out, loc_tile=tile, halo=h)
    return static, dict(colidx_pad=colidx, vals_pad=vals,
                        row_start=row_start, row_end=row_end,
                        out_index=out_index, loc_colidx=lcol, loc_vals=lval,
                        loc_row_start=lstart, loc_row_end=lend,
                        in_index=in_index)


def _place_scan(mesh: Mesh, axis: str, s: Dict[str, Any],
                arr: Dict[str, Optional[np.ndarray]]) -> DistSpmvPlan:
    dev0 = mesh.home
    halo = s["x_mode"] == "halo"

    def idx(name):
        v = arr.get(name)
        return None if v is None else _shards(mesh, v, index=True)

    return DistSpmvPlan(
        mesh=mesh, axis=axis, ndev=mesh.shape[axis], m=s["m"], n=s["n"],
        nnz=s["nnz"], tile=s["tile"], mr=s["mr"],
        row_splitter=np.asarray(s["row_splitter"]), x_mode=s["x_mode"],
        colidx_pad=idx("colidx_pad"),
        vals_pad=_value_shards(mesh, arr["vals_pad"]),
        row_start=idx("row_start"), row_end=idx("row_end"),
        out_index=(None if s["identity_out"] else dev_put(
            np.asarray(arr["out_index"]).astype(np.int64), dev0)),
        identity_out=s["identity_out"],
        loc_colidx=idx("loc_colidx"),
        loc_vals=_value_shards(mesh, arr["loc_vals"]) if halo else None,
        loc_row_start=idx("loc_row_start"), loc_row_end=idx("loc_row_end"),
        loc_tile=s["loc_tile"], halo=s["halo"] if halo else 0,
        in_index=(None if arr.get("in_index") is None else dev_put(
            np.asarray(arr["in_index"]).astype(np.int64), dev0)))


def dist_spmv(plan: DistSpmvPlan, x) -> torch.Tensor:
    """Execute y = A @ x across the mesh."""
    mesh = plan.mesh
    x = _x_in(mesh, x, plan.n, plan.dtype)
    scan = torch_csr.scan_spmv_tiled
    if plan.x_mode == "halo":
        if plan.in_index is None:           # uniform split: pure zero-pad
            xb = _pad(x, plan.mr * plan.ndev)
        else:                               # splitter-aligned block gather
            xb = torch.cat([x, x.new_zeros(1)])[plan.in_index]
        blocks = _blocks(mesh, xb)
        windows = _windows(mesh, blocks, plan.halo)
        # the local stream reads only the shard's own block; the remote one
        # its halo window
        ys = [scan(plan.loc_colidx[d], plan.loc_vals[d],
                   plan.loc_row_start[d], plan.loc_row_end[d], blocks[d],
                   tile=plan.loc_tile)
              + scan(plan.colidx_pad[d], plan.vals_pad[d],
                     plan.row_start[d], plan.row_end[d], windows[d],
                     tile=plan.tile) if mesh.owns(d) else None
              for d in range(plan.ndev)]
    else:
        xs = _assemble(mesh, x, plan.x_mode, 0, plan.mr, plan.n)
        ys = [scan(plan.colidx_pad[d], plan.vals_pad[d], plan.row_start[d],
                   plan.row_end[d], xs[d], tile=plan.tile)
              if mesh.owns(d) else None for d in range(plan.ndev)]
    y = _concat(mesh, ys)
    if plan.identity_out:
        return y[:plan.m]
    return y[plan.out_index]


# --------------------------------------------------------------------------
# Row-blocked DIA
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DistDiaPlan:
    """Row-blocked DIA over a 1-D mesh: shard d owns rows [d*mr, (d+1)*mr)
    and runs the shifted-FMA plan (``ops/torch_csr.dia_spmv``) against x
    replicated, all-gathered, or with its band edges from its neighbours
    (``x_mode="halo"``: square matrices with max |offset| ≤ mr)."""

    mesh: Mesh
    axis: str
    ndev: int
    m: int
    n: int
    nnz: int
    offsets: tuple
    mr: int                     # rows per shard (padded)
    data: tuple                 # (ndiags, mr) a shard, f32/bf16/f64
    x_mode: str

    def __call__(self, x) -> torch.Tensor:
        return dist_dia_spmv(self, x)

    @property
    def dtype(self) -> torch.dtype:
        return _value_dtype(_first(self.data))


def build_dist_dia_plan(a: CsrMatrix, mesh: Mesh, axis: str = "rows",
                        x_mode: str = "replicated") -> DistDiaPlan:
    if x_mode not in _X_MODES:
        raise ValueError(f"unknown x_mode {x_mode!r}")
    return _place_dia(mesh, axis, *_pack_dia(a, mesh.shape[axis], x_mode))


def _pack_dia(a: CsrMatrix, ndev: int, x_mode: str):
    from ..formats.dia import pack_dia
    d = pack_dia(a)
    mr = max(-(-a.m // ndev), 1)
    if x_mode == "halo":
        if a.m != a.n:
            raise ValueError("halo mode requires a square matrix")
        h = max((max(abs(int(o)) for o in d.offsets), 1)) \
            if len(d.offsets) else 1
        if h > mr:
            raise ValueError(
                f"halo {h} exceeds shard width {mr}; use allgather")
    data = np.zeros((ndev, len(d.offsets), mr), dtype=d.data.dtype)
    for dev in range(ndev):
        r0 = dev * mr
        r1 = min(r0 + mr, a.m)
        if r1 > r0:
            data[dev, :, : r1 - r0] = d.data[:, r0:r1]
    static = dict(m=a.m, n=a.n, nnz=a.nnz,
                  offsets=tuple(int(o) for o in d.offsets), mr=mr,
                  x_mode=x_mode)
    return static, {"data": data}


def _place_dia(mesh: Mesh, axis: str, s: Dict[str, Any],
               arr: Dict[str, np.ndarray]) -> DistDiaPlan:
    return DistDiaPlan(
        mesh=mesh, axis=axis, ndev=mesh.shape[axis], m=s["m"], n=s["n"],
        nnz=s["nnz"], offsets=tuple(int(o) for o in s["offsets"]),
        mr=s["mr"], x_mode=s["x_mode"],
        data=_value_shards(mesh, arr["data"]))


def dist_dia_spmv(plan: DistDiaPlan, x) -> torch.Tensor:
    mesh = plan.mesh
    x = _x_in(mesh, x, plan.n, plan.dtype)
    offsets, mr, n, nd = plan.offsets, plan.mr, plan.n, plan.ndev
    ys = []
    if plan.x_mode == "halo":
        h = max(max(abs(o) for o in offsets), 1) if offsets else 1
        # the band edges of the neighbouring blocks, circular as the
        # ppermute rings are (wrapped values meet zero diagonals)
        x_ext = _exchange(mesh, _blocks(mesh, _pad(x, mr * nd)), lambda d: [
            ((d - 1) % nd, mr - h, mr), (d, 0, mr), ((d + 1) % nd, 0, h)])
        ys = [torch_csr.dia_spmv(plan.data[d], x_ext[d], offsets, mr,
                                 pad_l=h) if mesh.owns(d) else None
              for d in range(nd)]
        return _concat(mesh, ys)[:plan.m]
    xs = _assemble(mesh, x, plan.x_mode, 0, mr, n)
    pad_l = max(0, -min(offsets)) if offsets else 0
    pad_r = (max(0, mr * nd + max(offsets) - n) + mr) if offsets else 0
    for d in range(nd):
        if not mesh.owns(d):
            ys.append(None)
            continue
        # shard d computes rows [d*mr, (d+1)*mr): its x offsets shift by
        # d*mr; x is padded so every slice is in range
        xpad = torch.cat([xs[d].new_zeros(pad_l), xs[d],
                          xs[d].new_zeros(pad_r)])
        ys.append(torch_csr.dia_spmv(plan.data[d], xpad, offsets, mr,
                                     row0=d * mr, pad_l=pad_l))
    return _concat(mesh, ys)[:plan.m]


# --------------------------------------------------------------------------
# Row-blocked SELL-8W: the v1 stream (K9, K10) on every shard
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DistSell8WPlan:
    """Row-blocked SELL-8W over a 1-D mesh: every shard owns ``mr`` rows
    (128-aligned, equal across shards) packed as a v1 stream, padded to a
    common tile count (padding tiles target the last group with first = 0
    and zero values), and runs ``sell_v1`` (f32, K9) or ``sell_v1_df``
    (f64 as hi + lo f32 planes, K10) against x replicated, all-gathered or
    in its halo window."""

    mesh: Mesh
    axis: str
    ndev: int
    m: int
    n: int
    nnz: int
    mr: int
    ntiles: int                 # common (padded) tiles per shard
    nslices: int                # per shard
    x_mode: str
    streams: tuple              # one v1 SellStream a shard, on its device
    max_pad: float = 0.0
    halo: int = 0

    def __call__(self, x) -> torch.Tensor:
        return dist_sell8w_spmv(self, x)

    @property
    def dtype(self) -> torch.dtype:
        return _first(self.streams).dtype


def _halo_depth(a: CsrMatrix, ndev: int, mr: int) -> int:
    """Ring depth of a block-aligned split: the furthest row block any
    shard's columns touch (x blocks = row blocks; m == n required)."""
    if a.m != a.n:
        raise ValueError("halo mode requires a square matrix")
    rowptr64 = a.rowptr.astype(np.int64)
    halo = 0
    for d in range(ndev):
        p0 = int(rowptr64[min(d * mr, a.m)])
        p1 = int(rowptr64[min((d + 1) * mr, a.m)])
        if p1 > p0:
            own = a.colidx[p0:p1] // mr
            halo = max(halo, d - int(own.min()), int(own.max()) - d)
    halo = max(halo, 1)
    if 2 * halo + 1 > ndev:
        raise ValueError(
            f"halo depth {halo} needs {2 * halo + 1} blocks > "
            f"ndev={ndev}; reorder for locality or use 'allgather'")
    return halo


def _shard_matrix(a: CsrMatrix, d: int, mr: int, x_mode: str, halo: int,
                  vals=None) -> CsrMatrix:
    """Shard d's rows [d*mr, (d+1)*mr) as an mr-row matrix (empty rows past
    m); halo mode localises its columns into the (2h+1)-block window."""
    rowptr64 = a.rowptr.astype(np.int64)
    r0 = min(d * mr, a.m)
    r1 = min(r0 + mr, a.m)
    local_rowptr = np.zeros(mr + 1, dtype=np.int64)
    if r1 > r0:
        seg = rowptr64[r0:r1 + 1] - rowptr64[r0]
        local_rowptr[: r1 - r0 + 1] = seg
        local_rowptr[r1 - r0 + 1:] = seg[-1]
    p0, p1 = int(rowptr64[r0]), int(rowptr64[r1])
    cols_d = a.colidx[p0:p1]
    n_local = a.n
    if x_mode == "halo":
        cols_d = (cols_d.astype(np.int64) - (d - halo) * mr) \
            .astype(INT_DTYPE)
        n_local = (2 * halo + 1) * mr
    v = np.asarray(a.vals if vals is None else vals)[p0:p1]
    return CsrMatrix(mr, n_local, local_rowptr.astype(INT_DTYPE), cols_d, v)


def build_dist_sell8w_plan(a: CsrMatrix, mesh: Mesh, axis: str = "rows",
                           x_mode: str = "replicated",
                           max_pad_ratio: float = None) -> DistSell8WPlan:
    if x_mode not in _X_MODES:
        raise ValueError(f"unknown x_mode {x_mode!r}")
    return _place_sell8w(mesh, axis, *_pack_sell8w(
        a, mesh.shape[axis], x_mode, max_pad_ratio))


def _pack_sell8w(a: CsrMatrix, ndev: int, x_mode: str,
                 max_pad_ratio: Optional[float]):
    from ..formats.sell8w import LANES, SUB, pack_sell8w
    df = a.dtype == np.float64
    if not df and a.dtype != np.float32:
        raise ValueError(
            "dist SELL-8W computes in float32 or double-float f64; "
            f"got {dtype_name(a.dtype)} — cast explicitly or use "
            "build_dist_plan")
    mr = max(-(-a.m // (ndev * LANES)) * LANES, LANES)
    halo = _halo_depth(a, ndev, mr) if x_mode == "halo" else 0
    if df:
        # double-float: pack twice (hi, lo); placement is value-independent,
        # so the two tile layouts are slot-aligned
        hi_all = np.asarray(a.vals).astype(np.float32)
        lo_all = (np.asarray(a.vals) - hi_all.astype(np.float64)) \
            .astype(np.float32)
    packs = []
    for d in range(ndev):
        if df:
            p_hi = pack_sell8w(_shard_matrix(a, d, mr, x_mode, halo, hi_all),
                               max_pad_ratio=max_pad_ratio)
            p_lo = pack_sell8w(_shard_matrix(a, d, mr, x_mode, halo, lo_all))
            packs.append((p_hi, p_lo.vals))
        else:
            packs.append((pack_sell8w(_shard_matrix(a, d, mr, x_mode, halo),
                                      max_pad_ratio=max_pad_ratio), None))
    ntiles = max(p.ntiles for p, _ in packs)
    nslices = mr // LANES
    ngroups = -(-nslices // SUB)
    win = np.zeros((ndev, ntiles), dtype=INT_DTYPE)
    gpk = np.zeros((ndev, ntiles), dtype=INT_DTYPE)
    meta = np.zeros((ndev, ntiles, SUB, LANES), dtype=np.int16)
    vals = np.zeros((ndev, ntiles, SUB, LANES), dtype=np.float32)
    vals_lo = (np.zeros((ndev, ntiles, SUB, LANES), dtype=np.float32)
               if df else None)
    for d, (p, lo_tiles) in enumerate(packs):
        win[d, : p.ntiles] = p.window_ids
        gpk[d, : p.ntiles] = sell_ops.pack_gpk(p.slice_ids)
        meta[d, : p.ntiles] = p.meta
        vals[d, : p.ntiles] = p.vals
        if df:
            vals_lo[d, : p.ntiles] = lo_tiles
        # padding tiles: the last group, first = 0, zero values
        if p.ntiles < ntiles:
            gpk[d, p.ntiles:] = (ngroups - 1) << 4
    static = dict(m=a.m, n=a.n, nnz=a.nnz, mr=mr, ntiles=ntiles,
                  nslices=nslices, x_mode=x_mode,
                  max_pad=max(p.pad_ratio for p, _ in packs), halo=halo)
    return static, dict(window_ids=win, gpk=gpk, meta=meta, vals=vals,
                        vals_lo=vals_lo)


def _place_sell8w(mesh: Mesh, axis: str, s: Dict[str, Any],
                  arr: Dict[str, Optional[np.ndarray]]) -> DistSell8WPlan:
    halo = s["halo"] if s["x_mode"] == "halo" else 0
    n_local = (2 * halo + 1) * s["mr"] if halo else s["n"]
    lo = arr.get("vals_lo")
    streams = tuple(
        sell_ops.prepare_v1(arr["window_ids"][d], arr["gpk"][d],
                            arr["meta"][d], arr["vals"][d], s["nslices"],
                            s["mr"], n_local, dev,
                            vals_lo=None if lo is None else lo[d])
        if mesh.owns(d) else None
        for d, dev in enumerate(mesh.devices))
    return DistSell8WPlan(
        mesh=mesh, axis=axis, ndev=mesh.shape[axis], m=s["m"], n=s["n"],
        nnz=s["nnz"], mr=s["mr"], ntiles=s["ntiles"], nslices=s["nslices"],
        x_mode=s["x_mode"], streams=streams, max_pad=s["max_pad"],
        halo=halo)


def dist_sell8w_spmv(plan: DistSell8WPlan, x) -> torch.Tensor:
    x = _x_in(plan.mesh, x, plan.n, plan.dtype)
    xs = _assemble(plan.mesh, x, plan.x_mode, plan.halo, plan.mr, plan.n)
    return _concat(plan.mesh, _run_streams(plan.streams, xs,
                                           plan.mr))[:plan.m]


def _run_streams(streams, xs, rows: int):
    """Each shard stream this process holds on its x, cut to ``rows``;
    None for other ranks' shards."""
    return [None if st is None else sell_ops.sell_spmv(st, xd)[:rows]
            for st, xd in zip(streams, xs)]


# --------------------------------------------------------------------------
# Row-blocked SELL-8D: the slot stream (K1, K2) on every shard
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DistSell8DPlan:
    """Row-blocked SELL-8D slot mode over a 1-D mesh: every shard owns
    ``mr`` rows (1024·nw-aligned) packed as a slot stream, padded to a
    common tile count, with one value mode and one palette for all shards.
    The shards' spills form ONE global straggler stream, added against the
    full x after the shards."""

    mesh: Mesh
    axis: str
    ndev: int
    m: int
    n: int
    nnz: int
    mr: int
    ntiles: int                 # common (padded) tiles per shard
    nsteps: int
    nslices: int                # per shard
    g: int
    nw: int
    value_mode: str
    x_mode: str
    streams: tuple              # one slot SellStream a shard
    max_pad: float = 0.0
    rest: Optional[tuple] = None   # _place_rest's, on mesh.home
    halo: int = 0

    def __call__(self, x) -> torch.Tensor:
        return dist_sell8d_spmv(self, x)

    @property
    def dtype(self) -> torch.dtype:
        return _first(self.streams).dtype


def _shared_value_mode(vals: np.ndarray, nw: int, df: bool):
    """Global value mode (the meta bit budget depends on nw) and ONE shared
    code table: per-shard palettes would decode each other's codes
    wrongly."""
    from ..formats.sell8w import df16_safe, value_palette
    lb = int(nw).bit_length() - 1
    if df:
        # f64: a shared palette of f64 values, else the df16 int16-lo plane
        # when the values fit its range, else full hi/lo f32 planes
        uniq = np.unique(vals[vals != 0.0])
        if len(uniq) + 1 <= (64 >> lb):
            return "palette_df", uniq
        if df16_safe(vals):
            return "df16", None
        return "df", None
    gp = value_palette(vals, max_entries=64 >> lb)
    if gp is not None:
        pal_shared = np.asarray(gp[0][1:])      # sorted unique nonzeros
        return "palette", pal_shared[pal_shared != 0.0]
    v32 = np.asarray(vals, dtype=np.float32)
    return ("bf16" if _bf16.is_lossless(v32) else "f32"), None


def _stack_slot_packs(packs, ndev: int, ntiles: int, nsteps: int,
                      nslices: int, force_mode: str):
    """Stack per-shard slot packs into the (ndev, ...) arrays of one padded
    stream.  The default stream (kept by EMPTY shards) visits every slice
    once with first = 1, then parks on the last slice."""
    from ..formats.sell8w import LANES, SUB
    tinfo = np.zeros((ndev, ntiles), dtype=INT_DTYPE)
    ginfo = np.full((ndev, nsteps), (nslices - 1) << 1, dtype=INT_DTYPE)
    ginfo[:, :nslices] = (np.arange(nslices, dtype=np.int64) << 1 | 1) \
        .astype(INT_DTYPE)
    meta = np.zeros((ndev, ntiles, SUB, LANES), dtype=np.int16)
    vals = vals_lo = None
    if force_mode in ("f32", "df", "df16"):
        vals = np.zeros((ndev, ntiles, SUB, LANES), dtype=np.float32)
    elif force_mode == "bf16":
        vals = np.zeros((ndev, ntiles, SUB, LANES), dtype=np.uint16)
    if force_mode == "df":
        vals_lo = np.zeros((ndev, ntiles, SUB, LANES), dtype=np.float32)
    elif force_mode == "df16":
        vals_lo = np.zeros((ndev, ntiles, SUB, LANES), dtype=np.int16)
    pal = np.zeros((SUB, LANES), dtype=np.float32)
    pal_lo = np.zeros((SUB, LANES), dtype=np.float32) \
        if force_mode == "palette_df" else None
    for d, p in enumerate(packs):
        if p is None:
            continue
        tinfo[d, : p.ntiles] = p.tinfo
        ginfo[d, : p.nsteps] = p.ginfo
        meta[d, : p.ntiles] = p.meta
        if vals is not None and p.vals is not None:
            vals[d, : p.ntiles] = p.vals
        if vals_lo is not None and p.vals_lo is not None:
            vals_lo[d, : p.ntiles] = p.vals_lo
        if p.palette is not None:
            pal = np.tile(p.palette[None, :], (SUB, 1)).astype(np.float32)
        if pal_lo is not None and p.palette_lo is not None:
            pal_lo = np.tile(p.palette_lo[None, :],
                             (SUB, 1)).astype(np.float32)
    return dict(tinfo=tinfo, ginfo=ginfo, meta=meta, vals=vals,
                vals_lo=vals_lo, pal=pal, pal_lo=pal_lo)


def _common_steps(packs, nslices: int):
    """(g, ntiles, nsteps) of the common padded stream: every output block
    gets at least one step."""
    g = next(p.g for p in packs if p is not None)
    ntiles = max((p.ntiles for p in packs if p is not None), default=g)
    ntiles = -(-ntiles // g) * g
    nsteps = ntiles // g
    if nsteps < nslices:
        nsteps = nslices
        ntiles = nsteps * g
    return g, ntiles, nsteps


def build_dist_sell8d_plan(a: CsrMatrix, mesh: Mesh, axis: str = "rows",
                           x_mode: str = "replicated",
                           nw: Optional[int] = None,
                           max_pad_ratio: float = 32.0,
                           prices: Optional[Prices] = None
                           ) -> DistSell8DPlan:
    """Shard rows into 1024·nw-aligned blocks and pack each as SELL-8D, with
    nw and the value mode chosen for the whole matrix (priced with
    ``prices``; None is the JAX package's table)."""
    if x_mode not in _X_MODES:
        raise ValueError(f"unknown x_mode {x_mode!r}")
    return _place_sell8d(mesh, axis, *_pack_sell8d(
        a, mesh.shape[axis], x_mode, nw, max_pad_ratio, prices))


def _pack_sell8d(a: CsrMatrix, ndev: int, x_mode: str, nw: Optional[int],
                 max_pad_ratio: float, prices: Optional[Prices] = None):
    from ..formats.sell8d import SLICE_ROWS, estimate_sell8d_auto, \
        pack_sell8d
    df = a.dtype == np.float64
    if not df and a.dtype != np.float32:
        raise ValueError("dist SELL-8D computes in float32 or double-"
                         "float f64; cast explicitly or use "
                         "build_dist_plan")
    if a.nnz == 0:
        raise ValueError("empty matrix has no SELL-8D packing")
    if nw is None:
        _t, _c, _s, nw = estimate_sell8d_auto(a, nw=None, prices=prices)
    align = SLICE_ROWS * nw
    mr = max(-(-a.m // (ndev * align)) * align, align)
    halo = _halo_depth(a, ndev, mr) if x_mode == "halo" else 0
    force_mode, pal_shared = _shared_value_mode(np.asarray(a.vals), nw, df)
    packs, rests = [], []
    for d in range(ndev):
        local = _shard_matrix(a, d, mr, x_mode, halo)
        if local.nnz == 0:
            packs.append(None)
            continue
        p, rest = pack_sell8d(local, max_pad_ratio=max_pad_ratio, nw=nw,
                              force_value_mode=force_mode,
                              palette_values=pal_shared, cell_w=nw > 1,
                              prices=prices)
        packs.append(p)
        if rest is not None:
            # rows and columns back to global ids
            r0 = min(d * mr, a.m)
            rcols = rest[1] + ((d - halo) * mr if x_mode == "halo" else 0)
            rests.append((rest[0] + r0, rcols, rest[2]))
    nslices = mr // SLICE_ROWS
    g, ntiles, nsteps = _common_steps(packs, nslices)
    arrays = _stack_slot_packs(packs, ndev, ntiles, nsteps, nslices,
                               force_mode)
    rest = None
    if rests:
        rest = tuple(np.concatenate([r[i] for r in rests])
                     for i in range(3))
    static = dict(m=a.m, n=a.n, nnz=a.nnz, mr=mr, ntiles=ntiles,
                  nsteps=nsteps, nslices=nslices, g=g, nw=nw,
                  value_mode=force_mode, x_mode=x_mode,
                  max_pad=max((p.pad_ratio for p in packs if p is not None),
                              default=0.0),
                  rest=rest, halo=halo)
    return static, arrays


def _slot_streams(mesh: Mesh, s: Dict[str, Any], arr, m: int, n: int):
    """One slot stream a shard from the stacked arrays: shard d's tiles,
    the shared palette (row 0 of the replicated (8, 128) table)."""
    vm = s["value_mode"]
    palette = vm in ("palette", "palette_df")

    def shard(name, d):
        v = arr.get(name)
        return None if v is None or palette else np.asarray(v)[d]

    return tuple(
        sell_ops.prepare_sell(SimpleNamespace(
            value_mode=vm, nslices=s["nslices"], g=s["g"], nw=s["nw"],
            cell_w=s["nw"] > 1, m=m, n=n, ginfo=arr["ginfo"][d],
            tinfo=arr["tinfo"][d], meta=arr["meta"][d],
            vals=shard("vals", d), vals_lo=shard("vals_lo", d),
            palette=np.asarray(arr["pal"])[0],
            palette_lo=(None if arr.get("pal_lo") is None
                        else np.asarray(arr["pal_lo"])[0])),
            dev, slot_mode=True) if mesh.owns(d) else None
        for d, dev in enumerate(mesh.devices))


def _place_sell8d(mesh: Mesh, axis: str, s: Dict[str, Any],
                  arr) -> DistSell8DPlan:
    halo = s["halo"] if s["x_mode"] == "halo" else 0
    n_local = (2 * halo + 1) * s["mr"] if halo else s["n"]
    return DistSell8DPlan(
        mesh=mesh, axis=axis, ndev=mesh.shape[axis], m=s["m"], n=s["n"],
        nnz=s["nnz"], mr=s["mr"], ntiles=s["ntiles"], nsteps=s["nsteps"],
        nslices=s["nslices"], g=s["g"], nw=s["nw"],
        value_mode=s["value_mode"], x_mode=s["x_mode"],
        streams=_slot_streams(mesh, s, arr, s["mr"], n_local),
        max_pad=s["max_pad"], rest=_place_rest(mesh, s["rest"]), halo=halo)


def dist_sell8d_spmv(plan: DistSell8DPlan, x) -> torch.Tensor:
    x = _x_in(plan.mesh, x, plan.n, plan.dtype)
    xs = _assemble(plan.mesh, x, plan.x_mode, plan.halo, plan.mr, plan.n)
    y = _concat(plan.mesh, _run_streams(plan.streams, xs,
                                        plan.mr))[:plan.m]
    return _add_rest(y, plan.rest, x)


# --------------------------------------------------------------------------
# Column-sharded SELL-8D: each shard one block of columns, one psum
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DistSell8DColsPlan:
    """Column-sharded slot-mode plan: shard d owns one bundle-aligned block
    of ``cw`` columns (its x slice is its natural x block), computes a
    partial y over all m rows, and the partials add up over the mesh."""

    mesh: Mesh
    axis: str
    ndev: int
    m: int
    n: int
    nnz: int
    cw: int                     # columns per shard (bundle-aligned)
    ntiles: int
    nsteps: int
    nslices: int                # full ceil(m/1024) — every shard outputs m
    g: int
    nw: int
    value_mode: str
    streams: tuple
    max_pad: float = 0.0
    rest: Optional[tuple] = None

    def __call__(self, x) -> torch.Tensor:
        return dist_sell8d_cols_spmv(self, x)

    @property
    def dtype(self) -> torch.dtype:
        return _first(self.streams).dtype


def build_dist_sell8d_cols_plan(a: CsrMatrix, mesh: Mesh,
                                axis: str = "rows",
                                nw: Optional[int] = None,
                                max_pad_ratio: float = 32.0,
                                prices: Optional[Prices] = None
                                ) -> DistSell8DColsPlan:
    """Shard COLUMNS into bundle-aligned blocks, pack each as SELL-8D.

    Each block must fit the JAX package's resident-x bound (raises when
    n/ndev > V2_MAX_N after alignment).  Packs keep empty slices, so every
    shard's partial covers all m rows and the sum needs no visibility
    maps.  Priced with ``prices`` (None is the JAX package's table)."""
    return _place_sell8d_cols(mesh, axis, *_pack_sell8d_cols(
        a, mesh.shape[axis], nw, max_pad_ratio, prices))


def _pack_sell8d_cols(a: CsrMatrix, ndev: int, nw: Optional[int],
                      max_pad_ratio: float, prices: Optional[Prices] = None):
    from ..formats.sell8d import (SLICE_ROWS, STRIPE_ALIGN, _V2_MAX_N,
                                  estimate_sell8d_auto, pack_sell8d)
    from ..formats.sell8w import LANES, SUB
    df = a.dtype == np.float64
    if not df and a.dtype != np.float32:
        raise ValueError("dist SELL-8D computes in float32 or double-"
                         "float f64")
    if a.nnz == 0:
        raise ValueError("empty matrix has no SELL-8D packing")
    cw = max(-(-a.n // (ndev * STRIPE_ALIGN)) * STRIPE_ALIGN,
             STRIPE_ALIGN)
    if cw > _V2_MAX_N:
        raise ValueError(
            f"column shard width {cw} exceeds the VMEM-x envelope "
            f"({_V2_MAX_N}); use the row-sharded windowed plan")
    if nw is None:
        # resident pricing: each shard's x slice is resident
        _t, _c, _s, nw = estimate_sell8d_auto(a, nw=None, windowed=False,
                                              prices=prices)
    force_mode, pal_shared = _shared_value_mode(np.asarray(a.vals), nw,
                                               df)
    lens = a.row_lengths.astype(np.int64)
    rows_all = np.repeat(np.arange(a.m, dtype=np.int64), lens)
    colidx = np.asarray(a.colidx, dtype=np.int64)
    vals_np = np.asarray(a.vals)
    packs, rests = [], []
    tot_tiles = tot_kept = 0
    g_use = "auto"      # the first non-empty shard picks; one g serves all
    for d in range(ndev):
        lo, hi = d * cw, min((d + 1) * cw, a.n)
        keep = (colidx >= lo) & (colidx < hi)
        if not keep.any():
            packs.append(None)
            continue
        rows_d = rows_all[keep]
        rp = np.zeros(a.m + 1, np.int64)
        np.cumsum(np.bincount(rows_d, minlength=a.m), out=rp[1:])
        sub = CsrMatrix(a.m, cw, rp, (colidx[keep] - lo).astype(INT_DTYPE),
                        vals_np[keep])
        p, rest = pack_sell8d(sub, max_pad_ratio=float("inf"),
                              max_spill=1.0, nw=nw, g=g_use,
                              force_value_mode=force_mode,
                              palette_values=pal_shared, cell_w=nw > 1,
                              prices=prices)
        g_use = p.g
        packs.append(p)
        tot_tiles += p.ntiles
        tot_kept += p.nnz_stored
        if rest is not None:
            rests.append((rest[0], rest[1].astype(np.int64) + lo, rest[2]))
    if not tot_kept:
        raise ValueError("column-sharded pack kept no nonzeros")
    pad = tot_tiles * (SUB * LANES) / tot_kept
    if pad > max_pad_ratio:
        raise ValueError(f"column-sharded pad ratio {pad:.1f} exceeds "
                         f"{max_pad_ratio}")
    nslices = max(-(-a.m // SLICE_ROWS), 1)
    g, ntiles, nsteps = _common_steps(packs, nslices)
    arrays = _stack_slot_packs(packs, ndev, ntiles, nsteps, nslices,
                               force_mode)
    rest = None
    if rests:
        rest = tuple(np.concatenate([r[i] for r in rests])
                     for i in range(3))
    static = dict(m=a.m, n=a.n, nnz=a.nnz, cw=cw, ntiles=ntiles,
                  nsteps=nsteps, nslices=nslices, g=g, nw=nw,
                  value_mode=force_mode, max_pad=pad, rest=rest)
    return static, arrays


def _place_sell8d_cols(mesh: Mesh, axis: str, s: Dict[str, Any],
                       arr) -> DistSell8DColsPlan:
    return DistSell8DColsPlan(
        mesh=mesh, axis=axis, ndev=mesh.shape[axis], m=s["m"], n=s["n"],
        nnz=s["nnz"], cw=s["cw"], ntiles=s["ntiles"], nsteps=s["nsteps"],
        nslices=s["nslices"], g=s["g"], nw=s["nw"],
        value_mode=s["value_mode"],
        streams=_slot_streams(mesh, s, arr, s["m"], s["cw"]),
        max_pad=s["max_pad"], rest=_place_rest(mesh, s["rest"]))


def dist_sell8d_cols_spmv(plan: DistSell8DColsPlan, x) -> torch.Tensor:
    x = _x_in(plan.mesh, x, plan.n, plan.dtype)
    blocks = _blocks(plan.mesh, _pad(x, plan.cw * plan.ndev))
    y = _psum(plan.mesh, _run_streams(plan.streams, blocks, plan.m))
    return _add_rest(y, plan.rest, x)


# --------------------------------------------------------------------------
# Distributed AUTO
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DistAutoPlan:
    """A mesh SpMV plan chosen automatically; call it like a function."""

    kind: str        # dia | sell8d_cols | hybrid | sell8w | sell8d | graph
    #                  | scan
    x_mode: str
    m: int
    n: int
    nnz: int
    parts: dict
    value_mode: Optional[str] = None
    max_pad: float = 0.0
    #: halo-mode straggler stream (_place_rest's) on mesh.home: the
    #: ≤0.1% long-range nonzeros split out so the quantile halo gate holds
    rest: Optional[tuple] = None

    def __call__(self, x) -> torch.Tensor:
        return dist_auto_spmv(self, x)


def _auto_x_mode(a: CsrMatrix, ndev: int) -> str:
    """x placement from the data: halo for a square matrix whose columns'
    spread from the diagonal stays within one shard's rows at the 99.9th
    percentile (the stragglers ride the plan-level rest stream), with more
    than 2 shards; else replicated up to 1M columns, allgather past."""
    if a.m == a.n and a.nnz and ndev > 2:
        mr = -(-a.m // ndev)
        rows = np.repeat(np.arange(a.m, dtype=np.int64), a.row_lengths)
        spread = np.abs(a.colidx.astype(np.int64) - rows)
        if np.quantile(spread, 0.999) <= mr:
            return "halo"
    return "replicated" if a.n <= 1_000_000 else "allgather"


def _halo_straggler_split(a: CsrMatrix, mr: int):
    """Split nonzeros with column spread > ``mr`` into a COO rest stream:
    ``(main, rest)``, rest None when nothing spills."""
    rows = np.repeat(np.arange(a.m, dtype=np.int64), a.row_lengths)
    cols = np.asarray(a.colidx, dtype=np.int64)
    far = np.abs(cols - rows) > mr
    if not far.any():
        return a, None
    keep = ~far
    rp = np.zeros(a.m + 1, np.int64)
    np.cumsum(np.bincount(rows[keep], minlength=a.m), out=rp[1:])
    main = CsrMatrix(a.m, a.n, rp, np.asarray(a.colidx)[keep],
                     np.asarray(a.vals)[keep])
    return main, (rows[far], cols[far], np.asarray(a.vals)[far])


def build_dist_auto(a: CsrMatrix, mesh: Mesh, axis: str = "rows",
                    x_mode: str = "auto",
                    prices: Optional[Prices] = None) -> DistAutoPlan:
    """One-call distributed handle: the plan family AND x placement, by the
    JAX package's gates, priced with ``prices`` (``formats/prices.py``;
    None is ``REFERENCE``, the JAX package's table): banded → dist DIA; past
    2M columns with blocks that fit → column shards; heavy-tailed mixes →
    the row-split hybrid (dense 8W part + light 8D part); windowed pad ≤ 32
    → dist SELL-8W or SELL-8D by cost; f32 web graphs → the graph split;
    else the exact-nnz scan.  Every builder falls back down the ladder on
    ValueError."""
    ndev = mesh.shape[axis]
    dev0 = mesh.home
    xm = _auto_x_mode(a, ndev) if x_mode == "auto" else x_mode
    auto_rest = None
    if xm == "halo" and a.m == a.n and a.nnz:
        # long-range stragglers out of the sharded stream so halo depth 1
        # holds; they run once against the full x a call
        a, far = _halo_straggler_split(a, -(-a.m // ndev))
        auto_rest = _place_rest(mesh, far)

    def _with_fallback(build, *args, **kw):
        # degrade x placement rather than fail the family
        modes = [xm] + [m for m in ("allgather", "replicated") if m != xm]
        err = None
        for m in modes:
            try:
                return build(*args, x_mode=m, **kw), m
            except ValueError as e:
                err = e
        raise err

    def _idx(v):
        return dev_put(np.asarray(v).astype(np.int64), dev0)

    # the kernel plans take f32 and f64; a bf16 matrix takes the scan, as
    # the JAX package's Pallas gate sends it
    kernel_ok = a.dtype in (np.float32, np.float64)
    if a.nnz and kernel_ok:
        from ..formats.dia import dia_profile
        from ..formats.sell8d import (STRIPE_ALIGN, _V2_MAX_N, cost_tables,
                                      dense_tile_ns, estimate_sell8d_auto,
                                      prepare_hybrid)
        from ..formats.sell8w import WINDOW, estimate_sell8w_tiles
        from ..inspector import _pairs_floor_pad
        df = a.dtype == np.float64
        ndiags, fill = dia_profile(a)
        if ndiags and ndiags <= 256 and fill >= 0.3:
            try:
                plan, m_used = _with_fallback(build_dist_dia_plan, a, mesh,
                                              axis)
                return DistAutoPlan(kind="dia", x_mode=m_used, m=a.m,
                                    n=a.n, nnz=a.nnz, parts={"dia": plan},
                                    rest=auto_rest)
            except ValueError:
                pass
        if (a.n > _V2_MAX_N
                and -(-a.n // (ndev * STRIPE_ALIGN)) * STRIPE_ALIGN
                <= _V2_MAX_N
                and _pairs_floor_pad(a) <= 32.0):
            # past 2M columns, column shards each with a resident x block
            # and one sum
            try:
                plan = build_dist_sell8d_cols_plan(a, mesh, axis,
                                                   max_pad_ratio=32.0,
                                                   prices=prices)
                return DistAutoPlan(
                    kind="sell8d_cols", x_mode="col-shards", m=a.m, n=a.n,
                    nnz=a.nnz, parts={"sell8d_cols": plan},
                    value_mode=plan.value_mode, max_pad=plan.max_pad,
                    rest=auto_rest)
            except ValueError:
                pass
        if _pairs_floor_pad(a) <= 32.0:
            t8d, _cap, spilled, nw = estimate_sell8d_auto(a, nw=None,
                                                          prices=prices)
            pad8d = t8d * WINDOW / a.nnz if t8d else float("inf")
            if spilled > 0.02 * a.nnz:
                pad8d = float("inf")
            t8w = estimate_sell8w_tiles(a)
            pad8w = t8w * WINDOW / a.nnz if t8w else float("inf")
            ts_tab, spill_ns = cost_tables(False, df, prices)
            cost_8w = (t8w * dense_tile_ns(df, prices) if t8w
                       else float("inf"))
            cost_8d = (t8d * ts_tab[nw] + spilled * spill_ns
                       if pad8d < float("inf") else float("inf"))
            prep = None
            if min(pad8w, pad8d) > 4.0:
                prep = prepare_hybrid(a, prices=prices)
                if (prep is not None
                        and (prep.cost >= 0.85 * min(cost_8w, cost_8d)
                             or prep.spilled > 0.02 * a.nnz)):
                    prep = None
            if prep is not None:
                try:
                    # the dense part is a compact k×n matrix: halo falls
                    # back inside
                    dense_plan, mu1 = _with_fallback(
                        build_dist_sell8w_plan, prep.dense_sorted, mesh,
                        axis, max_pad_ratio=96.0)
                    # per-shard pads pass the global estimate (shard
                    # boundaries split slices and pairs): the light part's
                    # allowance is the memory cap under a 96 ceiling
                    allow_s = min(96.0, 6.7e8 / max(prep.sparse.nnz, 1))
                    light_plan, mu2 = _with_fallback(
                        build_dist_sell8d_plan, prep.sparse, mesh, axis,
                        nw=prep.nw, max_pad_ratio=allow_s, prices=prices)
                    return DistAutoPlan(
                        kind="hybrid", x_mode=f"{mu1}/{mu2}", m=a.m, n=a.n,
                        nnz=a.nnz,
                        parts={"dense": dense_plan, "light": light_plan,
                               "fold_rows": _idx(prep.fold_rows)},
                        value_mode=light_plan.value_mode,
                        max_pad=prep.tiles * WINDOW / a.nnz, rest=auto_rest)
                except ValueError:
                    pass
            if pad8w <= 32.0 and cost_8w <= cost_8d:
                try:
                    plan, m_used = _with_fallback(
                        build_dist_sell8w_plan, a, mesh, axis,
                        max_pad_ratio=32.0)
                    return DistAutoPlan(
                        kind="sell8w", x_mode=m_used, m=a.m, n=a.n,
                        nnz=a.nnz, parts={"sell8w": plan},
                        max_pad=plan.max_pad, rest=auto_rest)
                except ValueError:
                    pass
            if pad8d <= 32.0:
                try:
                    plan, m_used = _with_fallback(
                        build_dist_sell8d_plan, a, mesh, axis, nw=nw,
                        prices=prices)
                    return DistAutoPlan(
                        kind="sell8d", x_mode=m_used, m=a.m, n=a.n,
                        nnz=a.nnz, parts={"sell8d": plan},
                        value_mode=plan.value_mode, max_pad=plan.max_pad,
                        rest=auto_rest)
                except ValueError:
                    pass
            if pad8w <= 32.0:
                try:
                    plan, m_used = _with_fallback(
                        build_dist_sell8w_plan, a, mesh, axis,
                        max_pad_ratio=32.0)
                    return DistAutoPlan(
                        kind="sell8w", x_mode=m_used, m=a.m, n=a.n,
                        nnz=a.nnz, parts={"sell8w": plan},
                        max_pad=plan.max_pad, rest=auto_rest)
                except ValueError:
                    pass
        if not df:
            # web-graph split: hub-column x-extension + heavy/light rows,
            # each part on its own dist builder, the heavy output folded by
            # the light plan's x-extension entries
            from ..formats.graph import prepare_graph_split
            from ..handle import _append_fold_entries, _graph_gate
            gprep = prepare_graph_split(a, prices=prices)
            if _graph_gate(a, gprep):
                try:
                    parts = {}
                    light_mat = gprep.light
                    mu_h = None
                    if gprep.heavy is not None:
                        heavy_plan, mu_h = _with_fallback(
                            build_dist_sell8w_plan, gprep.heavy, mesh,
                            axis, max_pad_ratio=96.0)
                        parts["heavy"] = heavy_plan
                        light_mat = _append_fold_entries(
                            gprep.light, gprep.fold_rows,
                            np.asarray(gprep.light.vals).dtype)
                    light_plan, mu_l = _with_fallback(
                        build_dist_sell8d_plan, light_mat, mesh, axis,
                        nw=gprep.nw, max_pad_ratio=96.0, prices=prices)
                    parts["light"] = light_plan
                    if gprep.hub_cols is not None:
                        parts["hub_cols"] = _idx(gprep.hub_cols)
                    return DistAutoPlan(
                        kind="graph",
                        x_mode=(f"{mu_h}/{mu_l}" if mu_h else mu_l),
                        m=a.m, n=a.n, nnz=a.nnz, parts=parts,
                        value_mode=light_plan.value_mode,
                        max_pad=gprep.pad_ratio(a.nnz), rest=auto_rest)
                except ValueError:
                    pass
    # the exact-nnz scan serves any matrix
    plan, m_used = _with_fallback(build_dist_plan, a, mesh, axis)
    return DistAutoPlan(kind="scan", x_mode=m_used, m=a.m, n=a.n,
                        nnz=a.nnz, parts={"scan": plan}, rest=auto_rest)


def dist_auto_spmv(plan: DistAutoPlan, x) -> torch.Tensor:
    """Execute a :func:`build_dist_auto` plan."""
    p = plan.parts
    if plan.kind == "dia":
        y = dist_dia_spmv(p["dia"], x)
    elif plan.kind == "sell8w":
        y = dist_sell8w_spmv(p["sell8w"], x)
    elif plan.kind == "sell8d":
        y = dist_sell8d_spmv(p["sell8d"], x)
    elif plan.kind == "sell8d_cols":
        y = dist_sell8d_cols_spmv(p["sell8d_cols"], x)
    elif plan.kind == "graph":
        light = p["light"]
        xj = _x_in(light.mesh, x, plan.n, light.dtype)
        hub = p.get("hub_cols")
        x_ext = torch.cat([xj, xj[hub]]) if hub is not None else xj
        if "heavy" in p:
            yh = dist_sell8w_spmv(p["heavy"], x_ext)
            y = dist_sell8d_spmv(light, torch.cat([x_ext,
                                                   yh.to(x_ext.dtype)]))
        else:
            y = dist_sell8d_spmv(light, x_ext)
    elif plan.kind == "hybrid":
        y = dist_sell8d_spmv(p["light"], x)
        yd = dist_sell8w_spmv(p["dense"], x)
        k = p["dense"].m
        # distinct rows (one a compact heavy row): one add a row
        y = y.index_add_(0, p["fold_rows"], yd[:k].to(y.dtype))
    else:
        y = dist_spmv(p["scan"], x)
    if plan.rest is not None:
        mesh = next(v.mesh for v in p.values() if hasattr(v, "mesh"))
        y = _add_rest(y, plan.rest, _x_in(mesh, x, plan.n, y.dtype))
    return y
