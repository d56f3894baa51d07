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
  times 2;
* :func:`fma_err` — P8 (``probe_r4_compute.py:probe_fma``): ``a·b − p``
  with ``p = fl(a·b)``.  On sm_90 the kernel is one IEEE fused
  multiply-add (``__fmaf_rn``), so the error comes out exact; the probe
  asserts it does.

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
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import _build
from ..formats import _bf16
from ..formats.sell8w import LANES, SUB, WINDOW
from . import timing

__all__ = ["tile_stream", "tile_stream_plain", "tile_body", "tile_body_plain",
           "window_gather", "window_gather_plain", "tiny", "tiny_plain",
           "fma_err", "fma_err_plain", "probe_inputs", "probe_stream",
           "probe_g8", "probe_huge", "probe_v2proto", "probe_body",
           "probe_tiny", "probe_step", "probe_fma", "probe_wide_gather",
           "p9_arrays", "run_probes", "calibrate", "KERNEL_COUNTS"]

#: launches of each probe kernel; reset by callers that count
tile_stream_launches = 0
tile_body_launches = 0
window_gather_launches = 0
tiny_launches = 0
fma_err_launches = 0
#: kernel name → its count's attribute in this module
KERNEL_COUNTS = {"tile_stream": "tile_stream_launches",
                 "tile_body": "tile_body_launches",
                 "window_gather": "window_gather_launches",
                 "tiny": "tiny_launches", "fma_err": "fma_err_launches"}

#: the value modes and gather stages of :func:`tile_body`
BODY_VALUES = {"f32": 0, "bf16": 1, "palette": 2, "dyadic": 3}
BODY_GATHERS = {"full": 0, "no_dim1": 1, "none": 2}
#: P9's bundle: 8 windows of 1024 columns
P9_NW = 8


def _count(name: str) -> None:
    attr = KERNEL_COUNTS[name]
    globals()[attr] += 1


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


def _steps_a_block(nsteps: int, device) -> int:
    """Steps a CUDA block walks: about 8 blocks an SM."""
    from ..ops.sell import sm_count
    return max(-(-nsteps // (sm_count(device) * 8)), 1)


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
    (ntiles, 8, 128) f32, ``c`` (8, 128) f32.  With ``accumulate`` the
    blocks' partials are added by the last block to finish, in block order;
    ``ticket`` (one int32 0, which each launch leaves 0) may be kept by the
    caller across launches, else one is made."""
    if not _on_card("tile_stream", vals, c):
        return tile_stream_plain(vals, block, accumulate, c)
    if (vals.dtype != torch.float32 or c.dtype != torch.float32
            or tuple(vals.shape[1:]) != (SUB, LANES)
            or tuple(c.shape) != (SUB, LANES) or block < 1):
        raise ValueError("tile_stream: f32 (ntiles, 8, 128) tiles, an f32 "
                         "(8, 128) carry and block >= 1")
    dev = vals.device
    nsteps = vals.shape[0] // block
    spb = _steps_a_block(nsteps, dev)
    nblk = max(-(-nsteps // spb), 1)
    if accumulate:
        out = torch.empty(SUB, LANES, dtype=torch.float32, device=dev)
        partial = torch.empty(nblk * WINDOW, dtype=torch.float32, device=dev)
        if ticket is None:
            ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    else:
        out = torch.empty(nsteps, SUB, LANES, dtype=torch.float32,
                          device=dev)
        partial = None
    lib = _build.load_kernels()
    err = lib.spmv_probe_tile_stream(
        vals.data_ptr(), c.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        ticket.data_ptr() if accumulate else None, nsteps, block, spb,
        int(accumulate), _stream(dev))
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


def tile_body_plain(b: BodyStream, init: torch.Tensor) -> torch.Tensor:
    """The body's sums, (ngroups, 8, 128): for each tile t (window
    ``tinfo >> 3``, or 0 with ``fixed_window``; row ``tinfo & 7``) and lane
    j, contrib = Σ_i value(i, j) · xg(i, j), with xg = x[1024 w + 128 s +
    r], r = meta & 127 at the slot and s = (meta >> 7) & 7 read at the cell
    (i, r) (``no_dim1``: s at the slot and the lane's own column;
    ``none``: x[1024 w + 128 i + j]); contrib goes into row ``row`` of the
    step's output block (every row without ``mask``), and the first step of
    a block adds ``init``."""
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
    if b.mask:
        rows = torch.zeros(nt, SUB, LANES, dtype=torch.float32, device=dev)
        rows[torch.arange(nt, device=dev), ti & 7] = contrib
    else:
        rows = contrib[:, None, :].expand(nt, SUB, LANES)
    gi = b.ginfo.to(torch.int64)
    out = torch.zeros(b.ngroups, SUB, LANES, dtype=torch.float32,
                      device=dev)
    out.index_add_(0, (gi >> 1).repeat_interleave(b.g), rows)
    first = (gi >> 1)[(gi & 1) == 1]
    return out.index_add_(0, first, init.view(1, SUB, LANES)
                          .expand(len(first), SUB, LANES))


def tile_body(b: BodyStream, init: torch.Tensor) -> torch.Tensor:
    """P2/P4/P5's body: :func:`tile_body_plain` as a kernel, one CUDA block
    a run of steps, each run's sums added into its output blocks by atomic
    adds (their order varies: f32 sums in another order)."""
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
    nsteps = b.ginfo.numel()
    out = torch.zeros(b.ngroups, SUB, LANES, dtype=torch.float32,
                      device=dev)
    lib = _build.load_kernels()
    err = lib.spmv_probe_tile_body(
        b.meta.data_ptr(), None if b.vals is None else b.vals.data_ptr(),
        b.palette.data_ptr(), b.tinfo.data_ptr(), b.ginfo.data_ptr(),
        b.x.data_ptr(), init.data_ptr(), out.data_ptr(), nsteps, b.g,
        _steps_a_block(nsteps, dev), BODY_VALUES[b.value_mode],
        BODY_GATHERS[b.gather], int(b.mask), int(b.fixed_window),
        _stream(dev))
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


def window_gather(wide: bool, a0, a1, a2, x, nsteps: int) -> torch.Tensor:
    """P9's gather as a kernel: ``nsteps`` blocks, each over the same g
    tiles (the TPU probe's clamped block index reads them every step),
    each writing the same (8, 128) sum: :func:`window_gather_plain`."""
    ts = [t for t in (a0, a1, a2, x) if t is not None]
    if not _on_card("window_gather", *ts):
        return window_gather_plain(wide, a0, a1, a2, x)
    if any(t.dtype != torch.int32 for t in ts[:-1]) \
            or x.dtype != torch.float32 or x.numel() != P9_NW * WINDOW:
        raise ValueError("window_gather: int32 (g, 8, 128) index planes "
                         "and an f32 x of 8 windows")
    out = torch.empty(SUB, LANES, dtype=torch.float32, device=x.device)
    lib = _build.load_kernels()
    err = lib.spmv_probe_window_gather(
        a0.data_ptr(), a1.data_ptr(), None if a2 is None else a2.data_ptr(),
        x.data_ptr(), out.data_ptr(), a0.shape[0], nsteps, int(wide),
        _stream(x.device))
    _build.check(lib, err, "window_gather")
    _count("window_gather")
    return out


# -- tiny (P6) and fma_err (P8) -----------------------------------------------

def tiny_plain(v: torch.Tensor) -> torch.Tensor:
    return v * 2.0


def tiny(v: torch.Tensor) -> torch.Tensor:
    """P6: one (8, 128) f32 tile times 2, one launch."""
    if not _on_card("tiny", v):
        return tiny_plain(v)
    if v.dtype != torch.float32 or v.numel() != WINDOW:
        raise ValueError("tiny: one f32 (8, 128) tile")
    out = torch.empty_like(v)
    lib = _build.load_kernels()
    err = lib.spmv_probe_tiny(v.data_ptr(), out.data_ptr(),
                              _stream(v.device))
    _build.check(lib, err, "tiny")
    _count("tiny")
    return out


def fma_err_plain(a, b, p) -> torch.Tensor:
    """a·b − p in f64, rounded to f32: exact when p = fl(a·b) (the error
    of an f32 product is an f32)."""
    return (a.double() * b.double() - p.double()).float()


def fma_err(a, b, p) -> torch.Tensor:
    """P8: a·b − p a slot by one fused multiply-add (``__fmaf_rn``)."""
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


def probe_stream(vals: torch.Tensor) -> List[dict]:
    """P1 (``make_stream_fn``): S_big (64 tiles a step), S_tile (1),
    S_tile8 (8), accumulated into a carry, and S_nodep (8, one sum a
    step)."""
    recs = []
    ticket = torch.zeros(1, dtype=torch.int32, device=vals.device)
    c0 = torch.ones(SUB, LANES, dtype=torch.float32, device=vals.device)
    for name, block, acc in (("S_big", 64, True), ("S_tile", 1, True),
                             ("S_tile8", 8, True), ("S_nodep", 8, False)):
        nt = vals.shape[0] // block * block
        if acc:
            def step(c, block=block):
                return tile_stream(vals, block, True, c, ticket)
        else:
            def step(c, block=block):
                return tile_stream(vals, block, False, c)[0]
        ms, all_ms = _times(step, c0)
        recs.append({"variant": name, "ms": ms,
                     "gbs": nt * WINDOW * 4 / ms / 1e6, "all_ms": all_ms})
    return recs


def probe_huge(vals: torch.Tensor) -> dict:
    """P3 (``pallas_huge``): the carried stream sum at 512 tiles a step."""
    ticket = torch.zeros(1, dtype=torch.int32, device=vals.device)
    nt = vals.shape[0] // 512 * 512
    ms, all_ms = _times(lambda c: tile_stream(vals, 512, True, c, ticket),
                        torch.ones(SUB, LANES, dtype=torch.float32,
                                   device=vals.device))
    return {"variant": "B_huge512", "ms": ms,
            "gbs": nt * WINDOW * 4 / ms / 1e6, "all_ms": all_ms}


def probe_step(vals: torch.Tensor) -> List[dict]:
    """P7 (``tile_stream_time``): the carried stream sum at 1 and 8 tiles a
    step, from a zero carry."""
    ticket = torch.zeros(1, dtype=torch.int32, device=vals.device)
    recs = []
    for block in (1, 8):
        ms, _all = _times(
            lambda c, block=block: tile_stream(vals, block, True, c, ticket),
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


def probe_tiny(device, iters: int = 100) -> dict:
    """P6 (``tiny_pallas``): ms a launch over a chain of ``iters``
    dependent launches."""
    ms, all_ms = _times(tiny, torch.ones(SUB, LANES, dtype=torch.float32,
                                         device=device), iters=iters)
    return {"tiny_pallas_ms": ms, "all_ms": all_ms}


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
      (P6), the stream ceiling (best of P1/P3), and beside the table P4's
      bf16 tile over its palette tile (``vals_ns_p4``, a cross-check);
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
    gbs = max([r["gbs"] for r in probes["P1"]] + [probes["P3"]["gbs"]])
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
        "stream_gbs": gbs,
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
