"""Handle lifecycle + method dispatch (the port of ``spmv_tpu/handle.py``).

``create_handle`` inspects the matrix and builds a host-side plan (numpy
packs, routed exactly as the JAX package routes on a TPU), places it on
``device``, and binds an ``x -> y`` closure; ``spmv`` then runs only device
work.  Planning does not depend on the device: the CPU runs the same plans
as the card, through each kernel's plain PyTorch version, so the CPU tests
cover the plans the card runs.

Plans and what runs them:

=================  ==========================================================
DIA                ``ops/dia.py`` (K3, K4 for f64; also the JAX package's XLA
                   DIA plan)
SELL-8W v2 rows    ``ops/sell.py`` row mode (K1, K2 for f64), with the
                   mega-row fold; past 2M columns ``sell8w_v2w`` (K5
                   values, K7 for f64)
SELL-8D slots      ``ops/sell.py`` slot mode (K1, K2 for f64), nw 1/2/4/8,
                   cell_w; past 2M columns the one windowed stream (K6, K7
                   for f64) or column stripes (below)
column stripes     n > 2M: stripes of at most 2M columns, each a slot
                   stream over its slice of x (K1, K2), whose compact
                   outputs add into y; the router prices them against the
                   windowed stream with the JAX package's TPU constants
row-split hybrid   8W heavy rows + 8D light rows; the heavy output folds
                   back by a scatter-add (f32, and f64 past 2M columns) or
                   by x-extension (f64)
graph (f32)        hub columns appended to x, heavy rows as SELL-8W v2 (K1
                   row), light rows as SELL-8D (K1 slot) over x extended by
                   the hubs and by the heavy output
stragglers         compact per-row sums + one scatter-add (plain PyTorch)
COO2 (CSR5, f32)   ``ops/coo2.py``: pass 1 (K8) writes one product a slot,
                   pass 2 sums them by the SELL row-mode kernel in binary
                   mode (K5 binary) over R
XLA plans          plain PyTorch (``ops/torch_csr.py``), as the JAX package
                   runs them through XLA: Serial (gather + scatter-add),
                   the tiled scan (Balanced, CSR5's fall-through), the
                   global scan (BalancedYid), Balanced2's mega-row split,
                   the chunked SELL-C-σ (``VectorizedWay.NONE``, and where
                   no SELL tile plan fits), BCSR's block products
=================  ==========================================================

Method.CSR5 packs COO2 in f32; when the pass-2 gate refuses, and for every
f64 matrix, it retries the SELL tiers above (n ≤ 2M, as the JAX package
does), then the tiled scan.  AUTO's graph rung, the ``graph_prep`` hint and
the f32 last resort of the SELL ladder are the JAX planner's, TPU gate on.
``reorder=`` permutes rows and columns before planning, and x and y around
every call.

An f64 matrix runs in native f64 end to end: x, the kernels' sums and y.
A bf16 matrix (``torch.bfloat16``, ``types.CsrMatrix``) takes the routes
the JAX planner gives it on a TPU: every SELL and COO2 tile route is
f32/f64 only, so it runs the plain plans, in f32 (y is f32), and DIA, whose
bf16 diagonals go to K3 unchanged; its plan keeps bf16 values on the
device.  A matrix of any other type raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.autograd import profiler as _torch_profiler

from .types import (CsrMatrix, Method, VectorizedWay, METHOD_NAMES,
                    INT_DTYPE, dtype_name)
from .formats import (_bf16, dia as dia_fmt, partition, sell as sell_fmt,
                      sell8w as sell8w_fmt)
from .ops import coo2 as coo2_ops, dia as dia_ops, sell as sell_ops
from .formats.prices import Prices, table as price_table
from .ops import torch_csr
from .ops.sell import V2_MAX_N
from .utils import profiling
from .utils.profiling import dev_put, span, spanned

__all__ = [
    "SpmvHandle",
    "create_handle",
    "spmv",
    "spmv_create_handle_all_in_one",
    "spmv_clear_handle",
    "spmv_destory_handle",
    "spmv_destroy_handle",
]


# --------------------------------------------------------------------------
# Handle
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SpmvHandle:
    """Inspect-once/execute-many handle (reference ``spmv_Handle``,
    spmv_Defines.h:44-68)."""

    method: Method               # resolved (AUTO → concrete)
    requested_method: Method
    dtype: Any                   # the matrix's: np.dtype or torch.bfloat16
    m: int
    n: int
    nnz: int
    nthreads: int
    vectorized: VectorizedWay
    mtx_token: Optional[str]
    device: torch.device
    plan: Dict[str, Any]         # device tensors + static config
    _cleared: bool = False
    _bound: Any = None           # plan-bound executable (x -> y)
    perm: Any = None             # reorder permutation (None if not reordered)
    _matrix: Any = None          # host CsrMatrix before any reorder
    _reorder: Optional[str] = None  # reorder kind requested at create
    _prices: Optional[Prices] = None  # the price table planned with

    def __call__(self, x) -> torch.Tensor:
        return spmv(self, x)

    @property
    def method_name(self) -> str:
        return METHOD_NAMES[self.method]

    def __repr__(self) -> str:
        return (f"SpmvHandle({self.method_name}, {self.m}x{self.n}, "
                f"nnz={self.nnz}, dtype={dtype_name(self.dtype)}, "
                f"plan={plan_kind(self.plan)}, device={self.device})")

    def clear(self) -> None:
        """Drop device buffers + per-method prep, keep the matrix so
        :meth:`prepare` can re-prep (reference common.c:31-41)."""
        self.plan = {}
        self._bound = None

    def prepare(self, method: Optional[Method] = None) -> "SpmvHandle":
        """Re-prep a cleared handle on its retained matrix."""
        if self._cleared or self._matrix is None:
            raise RuntimeError("handle was destroyed; create a new one")
        req = Method(method) if method is not None else self.requested_method
        fresh = create_handle(self._matrix, method=req,
                              nthreads=self.nthreads,
                              vectorized=self.vectorized,
                              mtx_token=self.mtx_token,
                              reorder=self._reorder, device=self.device,
                              prices=self._prices)
        self.method = fresh.method
        self.requested_method = req
        self.plan = fresh.plan
        self._bound = fresh._bound
        self.perm = fresh.perm
        return self

    def destroy(self) -> None:
        """End the lifecycle (reference spmv_destory_handle, spmv.h:19)."""
        self.clear()
        self._matrix = None
        self._cleared = True


def plan_kind(plan: Dict[str, Any]) -> str:
    """Short name of a (host or placed) plan's shape."""
    if "graph" in plan:
        return "graph"
    if "hybrid" in plan:
        return "hybrid(8w+8d)"
    if "coo2" in plan:
        return "coo2"
    if "colidx_pad" in plan:
        return "balanced2" if "sub_start" in plan else "scan"
    if "cols" in plan:
        return "chunked-sell"
    if "blocks" in plan:
        return "bcsr"
    rest = "+rest" if ("rest_rows" in plan or "rest" in plan) else ""
    if "sell8d_stripes" in plan:
        return f"sell8d-striped[{len(plan['sell8d_stripes'])}]" + rest
    for key in ("sell8d", "sell8w_v2", "sell8w_v2w", "dia"):
        if key in plan:
            return key + rest
    return "serial" if "rows" in plan else "none"


# --------------------------------------------------------------------------
# Planning (host only: numpy packs, no device)
# --------------------------------------------------------------------------

def _pad_allow(soft_cap: float, mem_cap: float, floor: float = 3.0) -> float:
    """Pad allowance = min(soft_cap, mem_cap), with a convenience floor that
    never overrides the memory cap (handle.py of the JAX package)."""
    return min(max(floor, min(soft_cap, mem_cap)), mem_cap)


def _tile_for(nnz: int, nthreads: int, method: Method) -> int:
    """The equal-nnz tile length of the scan plans
    (``spmv_tpu/handle.py:_tile_for``): 4096 for Balanced, 1024 for the
    others (shorter tiles split mega-rows across more of them), halved
    until there are at least max(64, nthreads) tiles or the tile is 256."""
    base = 4096 if method == Method.BALANCED else 1024
    min_tiles = max(64, nthreads)
    while base > 256 and nnz // base < min_tiles:
        base //= 2
    return base


def _tiles_ok(a: CsrMatrix) -> bool:
    """Whether the SELL and COO2 tile routes take ``a``: f32 and f64 only,
    as the JAX planner gates its Pallas tile routes."""
    return a.dtype in (np.float32, np.float64)


def _build_plan(a: CsrMatrix, method: Method, nthreads: int,
                vectorized: VectorizedWay = VectorizedWay.VPU,
                hints: Optional[Dict[str, Any]] = None,
                prices: Optional[Prices] = None) -> Dict[str, Any]:
    """The JAX planner, as it routes on a TPU: for f32 and f64 the SELL
    tile plans and COO2 first, then the plans the JAX package runs through
    XLA, which every route falls back to (and which a bf16 matrix takes
    directly).  The SELL plans are priced with ``prices`` (None is the JAX
    package's table)."""
    if (method in (Method.SELL_C_SIGMA, Method.PARALLEL)
            and vectorized != VectorizedWay.NONE and _tiles_ok(a)):
        plan = _plan_sell(a, hints or {}, prices)
        if plan is not None:
            return plan
    if (method == Method.CSR5 and vectorized != VectorizedWay.NONE
            and _tiles_ok(a) and a.nnz > 0):
        plan = _plan_csr5(a, nthreads, vectorized, hints, prices)
        if plan is not None:
            return plan
    if method == Method.SERIAL:
        return {"rows": partition.row_ids(a), "colidx": a.colidx,
                "vals": a.vals}
    if method == Method.BALANCED2:
        # the mega-row split, or the reference's demotion to Balanced when
        # no row is longer than a tile (parallel_balanced2_spmv.c:87-90)
        tile = _tile_for(a.nnz, nthreads, method)
        b2 = partition.build_balanced2_plan(a, tile=tile)
        if b2 is None:
            plan = _build_plan(a, Method.BALANCED, nthreads, vectorized)
            plan["demoted"] = True
            return plan
        return {"tile": b2.inner.tile, "colidx_pad": b2.inner.colidx_pad,
                "vals_pad": b2.inner.vals_pad,
                "vrow_start": b2.inner.row_start,
                "vrow_end": b2.inner.row_end,
                "sub_start": b2.sub_ptr_start, "sub_end": b2.sub_ptr_end,
                "m_virtual": b2.m_virtual, "n_mega_rows": b2.n_mega_rows}
    if method in (Method.BALANCED, Method.BALANCED_YID, Method.CSR5):
        p = partition.build_tile_scan_plan(
            a, tile=_tile_for(a.nnz, nthreads, method))
        return {"tile": p.tile, "colidx_pad": p.colidx_pad,
                "vals_pad": p.vals_pad, "row_start": p.row_start,
                "row_end": p.row_end}
    if method == Method.BCSR:
        from .formats import bcsr as bcsr_fmt
        nblocks, fill = bcsr_fmt.bcsr_profile(a)
        if a.nnz and (fill < 0.02
                      or nblocks * bcsr_fmt.BLOCK ** 2 * 8 > 4e9):
            raise ValueError(
                f"BCSR unprofitable: {nblocks} blocks at fill {fill:.4f} "
                f"(densification would allocate "
                f"{nblocks * bcsr_fmt.BLOCK**2 * 4 / 1e9:.1f}+ GB)")
        b = bcsr_fmt.pack_bcsr(a)
        return {"blocks": b.blocks, "block_rows": b.block_rows,
                "block_cols": b.block_cols,
                "nblock_rows": -(-a.m // bcsr_fmt.BLOCK), "fill": b.fill}
    if method == Method.DIA:
        # one plan covers the JAX package's Pallas and XLA DIA plans: any
        # ndiags the profitability gate admits, any m and n; bf16
        # diagonals stay bf16
        ndiags, fill = dia_fmt.dia_profile(a)
        if a.nnz and (fill < 0.02 or ndiags > 4096):
            raise ValueError(
                f"DIA unprofitable: {ndiags} diagonals at fill {fill:.3f} "
                f"(would stream {ndiags * a.m * 4 / 1e6:.0f} MB per exec)")
        d = dia_fmt.pack_dia(a)
        return {"dia": d, "fill": d.fill,
                "offsets": tuple(int(o) for o in d.offsets), "n": a.n}
    if method in (Method.PARALLEL, Method.SELL_C_SIGMA):
        # the chunked SELL-C-σ plan; mega-rows explode its padding (depth
        # is a slice's longest row), so past pad 8 the tiled scan instead
        from .inspector import _sell_pad_ratio
        sigma = 1 if method == Method.PARALLEL else 32 * sell_fmt.LANES
        if a.nnz and _sell_pad_ratio(a.row_lengths.astype(np.int64),
                                     sigma=max(sigma, 1)) > 8.0:
            plan = _build_plan(a, Method.BALANCED, nthreads, vectorized)
            plan["sell_fallback"] = "scan"
            return plan
        s = sell_fmt.pack_sell(a, sigma=sigma)
        return {"cols": s.cols, "vals": s.vals, "chunk_ids": s.chunk_ids,
                "inv_pos": s.inv_pos, "nslices": s.nslices,
                "identity_order": s.identity_order,
                "padded_nnz": s.padded_nnz}
    raise ValueError(f"no plan for method {method}")


def _plan_csr5(a: CsrMatrix, nthreads: int, vectorized: VectorizedWay,
                hints: Optional[Dict[str, Any]],
                prices: Optional[Prices] = None
                ) -> Optional[Dict[str, Any]]:
    """The JAX planner's CSR5 branch on a TPU: the two-pass COO2 plan in
    f32; when its pass-2 gate refuses, and for any f64 matrix (the
    reference's CSR5 is f64 only), the SELL-8D / hybrid retry for n ≤ 2M
    when its estimates hold.  None when neither gives a SELL tile plan:
    the caller then builds the tiled scan."""
    if np.dtype(a.dtype) != np.dtype(np.float64):
        from .formats import coo2 as coo2_fmt
        try:
            packed = coo2_fmt.pack_coo2(a, max_pad2=8.0)
            return {"coo2": packed, "pad1": packed.pad_ratio_pass1,
                    "pad2": packed.pad_ratio_pass2}
        except ValueError:
            pass                    # the pass-2 gate refused
    if a.n <= V2_MAX_N:
        # the cheap estimates first, as the JAX planner does
        from .formats.sell8d import estimate_sell8d_auto, prepare_hybrid
        WINDOW = sell8w_fmt.WINDOW
        t8d, _c, sp, _w = estimate_sell8d_auto(a, nw=None, prices=prices)
        ok = (t8d and sp <= 0.02 * a.nnz and t8d * WINDOW / a.nnz <= 32.0
              and t8d * WINDOW <= 6.7e8)
        sub_hints = hints
        if not ok:
            # heavy-tailed scatter: the row-split hybrid may still hold
            prep = prepare_hybrid(a, prices=prices)
            if (prep is not None and prep.tiles * WINDOW / a.nnz <= 32.0
                    and prep.tiles * WINDOW <= 6.7e8
                    and prep.spilled <= 0.02 * a.nnz):
                ok = True
                sub_hints = {**(hints or {}), "hybrid_prep": prep}
        if ok:
            alt = _build_plan(a, Method.SELL_C_SIGMA, nthreads, vectorized,
                              hints=sub_hints, prices=prices)
            # a graph or XLA plan from the SELL branch does not count: the
            # JAX planner's CSR5 branch then takes its own tiled scan
            if any(k in alt for k in ("sell8d", "sell8d_stripes", "sell8w",
                                      "sell8w_v2", "sell8w_v2w", "hybrid")):
                return alt
    return None


def _append_fold_entries(mat: CsrMatrix, fold_rows: np.ndarray,
                         val_dtype) -> CsrMatrix:
    """``[mat | F]`` where ``F[fold_rows[j], j] = 1``: fold by x-extension
    (``spmv_tpu/handle.py:_append_fold_entries``).  Fold columns land at
    the end of each row, after every real column."""
    m, n = mat.m, mat.n
    k = len(fold_rows)
    lens = mat.row_lengths.astype(np.int64)
    extra = np.bincount(fold_rows, minlength=m).astype(np.int64)
    rp2 = np.zeros(m + 1, np.int64)
    np.cumsum(lens + extra, out=rp2[1:])
    total = int(rp2[-1])
    cols2 = np.empty(total, dtype=np.int64)
    vals2 = np.empty(total, dtype=val_dtype)
    rows_old = np.repeat(np.arange(m, dtype=np.int64), lens)
    old_pos = rp2[rows_old] + (np.arange(mat.nnz, dtype=np.int64)
                               - mat.rowptr.astype(np.int64)[rows_old])
    cols2[old_pos] = mat.colidx
    vals2[old_pos] = mat.vals
    order = np.argsort(fold_rows, kind="stable")
    fr = np.asarray(fold_rows, dtype=np.int64)[order]
    base = np.arange(k, dtype=np.int64)
    first = np.ones(k, dtype=bool)
    first[1:] = fr[1:] != fr[:-1]
    rank = base - np.maximum.accumulate(np.where(first, base, 0))
    pos = rp2[fr] + lens[fr] + rank
    cols2[pos] = n + order                       # column = n + j
    vals2[pos] = 1.0
    return CsrMatrix(m, n + k, rp2, cols2.astype(INT_DTYPE), vals2)


def _graph_gate(a: CsrMatrix, prep) -> bool:
    """Viability gate for the graph-split plan (``formats/graph.py``), as
    ``spmv_tpu/handle.py:_graph_gate``: within V2_MAX_N columns after the
    hub extension, pad bounded, spill bounded, f32."""
    return (prep is not None
            and a.dtype == np.float32
            and prep.n_ext <= V2_MAX_N
            and prep.pad_ratio(a.nnz) <= min(48.0, 6.7e8 / max(a.nnz, 1))
            and prep.spilled <= 0.02 * a.nnz)


def _build_graph_plan(a: CsrMatrix, prep,
                      prices: Optional[Prices] = None) -> Dict[str, Any]:
    """Pack the graph plan (``spmv_tpu/handle.py:_build_graph_plan``): hub
    columns appended to x, the heavy rows as SELL-8W v2 (K1 row mode), the
    light rows as SELL-8D (K1 slot mode) with one 1.0-valued entry a heavy
    row (row ``fold_rows[j]``, column ``n_ext + j``) that reads the heavy
    output appended to x.

    Straggler remainders keep their hub-remapped column ids and the light
    plan's straggler stream reads the fully extended x, whose prefix is x;
    heavy straggler rows are mapped back through ``fold_rows``, so the
    stream adds into the full-m output.  Raises ``ValueError`` when a pack
    refuses or the two streams pass the 6.7e8-slot cap."""
    from .formats import sell8d as sell8d_fmt
    p = price_table(prices)
    mem_cap = 6.7e8 / max(a.nnz, 1)
    rest_parts = []
    light_mat = prep.light
    heavy_plan = None
    fold_k = 0
    if prep.heavy is not None:
        hm = prep.heavy
        # values off the palette (duplicate sums) go to the straggler
        # stream, so the heavy stream keeps palette values
        hm_p, hoff = sell8w_fmt.split_offpalette(hm)
        if hoff is not None:
            rest_parts.append((prep.fold_rows[np.asarray(hoff[0])],
                               hoff[1], hoff[2]))
            hm = hm_p
        palette_ok = sell8w_fmt.value_palette(
            np.asarray(hm.vals)) is not None
        # a palette tile is priced at half a row-mode tile
        tile_price = p.row_tile_ns / 2 if palette_ok else p.row_tile_ns
        hm2, hrest, hfrac = sell8w_fmt.split_stragglers(hm)
        if hrest is not None and hfrac <= 0.05:
            # split only when the tiles saved beat the straggler stream
            saved = (sell8w_fmt.estimate_sell8w_tiles(hm)
                     - sell8w_fmt.estimate_sell8w_tiles(hm2))
            if saved * tile_price > len(hrest[0]) * p.pair_spill_ns:
                rest_parts.append((prep.fold_rows[np.asarray(hrest[0])],
                                   hrest[1], hrest[2]))
                hm = hm2
        packed_h = sell8w_fmt.pack_sell8w(
            hm, max_pad_ratio=_pad_allow(48.0, 6.7e8 / max(hm.nnz, 1)))
        v2 = sell8w_fmt.plan_v2(packed_h)
        heavy_plan = {"sell8w": packed_h, "sell8w_v2": v2,
                      "pad_ratio": packed_h.pad_ratio,
                      "value_mode": v2.value_mode}
        light_mat = _append_fold_entries(prep.light, prep.fold_rows,
                                         np.asarray(prep.light.vals).dtype)
        fold_k = hm.m
    packed, rest8d = sell8d_fmt.pack_sell8d(
        light_mat, max_pad_ratio=_pad_allow(48.0, mem_cap), nw=prep.nw,
        g="auto", cell_w=prep.nw > 1, prices=prices)
    rest_parts.insert(0, rest8d)
    light_plan: Dict[str, Any] = {
        "sell8d": packed, "pad_ratio": packed.pad_ratio,
        "value_mode": packed.value_mode, "nw": packed.nw}
    plan: Dict[str, Any] = {
        "graph": True, "light": light_plan,
        "pad_ratio": prep.pad_ratio(a.nnz),
        "value_mode": packed.value_mode,
        "heavy_frac": (prep.heavy.nnz / a.nnz
                       if prep.heavy is not None else 0.0)}
    if prep.hub_cols is not None:
        plan["hub_cols"] = prep.hub_cols.astype(INT_DTYPE)
    if heavy_plan is not None:
        plan["heavy"] = heavy_plan
        plan["fold_k"] = fold_k
        if ((packed.ntiles + packed_h.ntiles) * sell8w_fmt.WINDOW
                > 6.7e8):
            raise ValueError("graph plan tile stream exceeds the HBM "
                             "budget")
    parts = [r for r in rest_parts if r is not None]
    if parts:
        rows_r = np.concatenate([np.asarray(r[0]) for r in parts])
        light_plan["rest_rows"] = rows_r.astype(INT_DTYPE)
        light_plan["rest_cols"] = np.concatenate(
            [np.asarray(r[1]) for r in parts]).astype(INT_DTYPE)
        light_plan["rest_vals"] = np.concatenate(
            [np.asarray(r[2]) for r in parts])
        light_plan["rest_frac"] = len(rows_r) / max(a.nnz, 1)
    return plan


def _plan_sell(a: CsrMatrix, hints: Dict[str, Any],
               prices: Optional[Prices] = None) -> Optional[Dict[str, Any]]:
    """SELL_C_SIGMA / PARALLEL: row mode (SELL-8W v2) vs slot mode
    (SELL-8D) vs the row-split hybrid, by estimated tile count (f32) or
    estimated cost (the f64 hybrid gate) — the JAX planner's
    ``_plan_windowed`` ladder, with its graph plan (AUTO's ``graph_prep``
    hint, and the f32 last resort).  Past V2_MAX_N columns slot mode is
    column stripes or one windowed stream, by the JAX planner's cost gate,
    and row mode is a windowed ``sell8w_v2w`` stream.  Every cost is
    priced with ``prices`` (None is the JAX package's table).  None when
    no tile plan fits: the caller falls through to the chunked SELL
    plan."""
    from .formats.sell8d import (MAX_SPILL_STRIPED, MAX_STRIPES,
                                 column_stripe_bounds, cost_tables,
                                 dense_tile_ns, estimate_sell8d_auto,
                                 pack_sell8d, pack_sell8d_striped,
                                 prepare_hybrid, slot_stream_budget,
                                 stripe_overhead_ns)
    WINDOW = sell8w_fmt.WINDOW
    df = np.dtype(a.dtype) == np.dtype(np.float64)

    def _finish_rest(plan, rest_parts):
        """Merge host-side COO remainders into the plan's straggler
        stream."""
        parts = [r for r in rest_parts if r is not None]
        if not parts:
            return plan
        plan["rest_rows"] = np.concatenate(
            [np.asarray(r[0]) for r in parts]).astype(INT_DTYPE)
        plan["rest_cols"] = np.concatenate(
            [np.asarray(r[1]) for r in parts]).astype(INT_DTYPE)
        plan["rest_vals"] = np.concatenate([np.asarray(r[2])
                                            for r in parts])
        plan["rest_frac"] = len(plan["rest_rows"]) / max(a.nnz, 1)
        return plan

    def _sell8d_plan(mat, extra):
        # slot-mode deep-slice stream; the depth-cap tail and s-table
        # leftovers ride the straggler stream
        nw = extra.get("sell8d_nw", 1)
        mem_cap = slot_stream_budget(mat.vals, nw, df) / max(mat.nnz, 1)
        allow = extra.get("sell8d_allow", _pad_allow(32.0, mem_cap))
        if (mat.n > V2_MAX_N
                and len(column_stripe_bounds(mat.n)) <= MAX_STRIPES
                and extra.get("sell8d_striped", True)):
            # column stripes of ≤ V2_MAX_N columns, each packed as its own
            # slot stream over the slices it touches; the rest gets global
            # columns
            stripes, rest8d, pad = pack_sell8d_striped(
                mat, max_pad_ratio=allow, nw=nw, cell_w=nw > 1,
                prices=prices)
            vm = max(stripes, key=lambda s: s[3].ntiles)[3].value_mode
            plan = {"sell8d_stripes": stripes, "pad_ratio": pad,
                    "value_mode": vm, "nw": nw}
            return _finish_rest(plan, [rest8d, extra.get("rest_host")])
        packed, rest8d = pack_sell8d(
            mat, max_pad_ratio=allow, nw=nw, g="auto",
            max_spill=extra.get("sell8d_max_spill", 0.02), cell_w=nw > 1,
            prices=prices)
        plan = {"sell8d": packed, "pad_ratio": packed.pad_ratio,
                "value_mode": packed.value_mode, "nw": packed.nw}
        return _finish_rest(plan, [rest8d, extra.get("rest_host")])

    def _sell8w_plan(mat, extra):
        # mega-row virtual splitting, only when it improves the estimate
        mat2, sub_rows = sell8w_fmt.split_megarows(mat)
        if sub_rows is not None and (
                sell8w_fmt.estimate_sell8w_tiles(mat2)
                < sell8w_fmt.estimate_sell8w_tiles(mat)):
            mat = mat2
            extra = {**extra, "mega_sub_rows": sub_rows}
        # a windowed stream (past V2_MAX_N) gets a tighter pad allowance
        allow = _pad_allow(32.0 if mat.n <= V2_MAX_N else 8.0,
                           6.7e8 / max(mat.nnz, 1))
        packed = sell8w_fmt.pack_sell8w(mat, max_pad_ratio=allow)
        if df:
            # the greedy placement is value-independent, so packing the lo
            # parts of the values too gives slot-aligned (hi, lo) tiles
            hi_back = mat.vals.astype(np.float32).astype(np.float64)
            lo = sell8w_fmt.pack_sell8w(CsrMatrix(
                mat.m, mat.n, mat.rowptr, mat.colidx,
                (mat.vals - hi_back).astype(np.float32)))
            v2 = sell8w_fmt.plan_v2(packed, lo_tiles=lo.vals)
        else:
            v2 = sell8w_fmt.plan_v2(packed)
        key = "sell8w_v2" if mat.n <= V2_MAX_N else "sell8w_v2w"
        plan = {"sell8w": packed, "pad_ratio": packed.pad_ratio,
                "value_mode": v2.value_mode, key: v2}
        extra = dict(extra)
        rest_host = extra.pop("rest_host", None)
        plan.update(extra)
        return _finish_rest(plan, [rest_host])

    def _plan_windowed(mat, extra):
        gp = hints.get("graph_prep")
        if gp is not None and mat is a:
            # AUTO's graph rung prepared the split (webbase-shaped matrices,
            # where every single-format estimate explodes)
            try:
                return _build_graph_plan(a, gp, prices)
            except ValueError:
                pass
        if mat.nnz:
            # pairs-floor pre-gate: the coarse (1024-row slice, 8-window
            # bundle) pair count lower-bounds every windowed format
            ns8d = max(-(-mat.m // 1024), 1)
            nb8d = max(-(-mat.n // (1024 * 8)), 1)
            if ns8d * nb8d <= (1 << 28):
                rows_g = np.repeat(np.arange(mat.m, dtype=np.int64),
                                   mat.row_lengths)
                key_g = ((rows_g >> 10) * nb8d
                         + (mat.colidx.astype(np.int64) >> 13))
                pairs_lb = int(np.count_nonzero(np.bincount(
                    key_g, minlength=ns8d * nb8d)))
                lens_g = mat.row_lengths
                heavy_frac = lens_g[lens_g >= 16].sum() / mat.nnz
                if pairs_lb * WINDOW / mat.nnz > 96:
                    if heavy_frac < 0.05:
                        return _sell8w_plan(mat, extra)
                    hmask = (lens_g >= 16)[rows_g]
                    ph = int(np.count_nonzero(np.bincount(
                        key_g[hmask], minlength=ns8d * nb8d)))
                    nnz_h = int(np.count_nonzero(hmask))
                    if nnz_h == 0 or ph * WINDOW / nnz_h > 96:
                        return _sell8w_plan(mat, extra)
        striped = False
        max_sp = 0.02
        if (mat.n > V2_MAX_N
                and len(column_stripe_bounds(mat.n)) <= MAX_STRIPES):
            # past V2_MAX_N: column stripes (resident tiles plus a per-
            # stripe overhead) against one windowed stream, each with its
            # own bundle width and the striped spill budget, priced by the
            # price table
            t_res, _cr, sp_res, nw_res = estimate_sell8d_auto(
                mat, nw=None, windowed=False, max_spill=MAX_SPILL_STRIPED,
                prices=prices)
            if sp_res > MAX_SPILL_STRIPED * mat.nnz:
                t_res = 0
            t_win, _cw, sp_win, nw_win = estimate_sell8d_auto(
                mat, nw=None, windowed=True, max_spill=MAX_SPILL_STRIPED,
                prices=prices)
            if sp_win > MAX_SPILL_STRIPED * mat.nnz:
                t_win = 0
            ts_res, sns = cost_tables(False, df, prices)
            ts_win, _s2 = cost_tables(True, df, prices)
            inf = float("inf")
            cost_res = (t_res * ts_res[nw_res] + sp_res * sns
                        + stripe_overhead_ns(mat.n, prices)) if t_res else inf
            cost_win = (t_win * ts_win[nw_win] + sp_win * sns
                        ) if t_win else inf
            striped = cost_res < cost_win
            max_sp = MAX_SPILL_STRIPED
            if striped:
                t8d, spilled, nw = t_res, sp_res, nw_res
            else:
                t8d, spilled, nw = t_win, sp_win, nw_win
        else:
            t8d, _cap, spilled, nw = estimate_sell8d_auto(
                mat, nw=None, max_spill=max_sp, prices=prices)
            if spilled > max_sp * mat.nnz:
                t8d = 0                   # 8D alone not viable
        tried_8d = False
        if t8d and t8d * WINDOW / mat.nnz <= 4.5:
            # clearly good slot-mode pack: skip the row-mode estimate
            try:
                return _sell8d_plan(mat, {**extra, "sell8d_nw": nw,
                                          "sell8d_striped": striped,
                                          "sell8d_max_spill": max_sp})
            except ValueError:
                tried_8d = True
        t8w = sell8w_fmt.estimate_sell8w_tiles(mat)
        best = min(t for t in (t8w, t8d) if t) if (t8w or t8d) else 0
        if best and best * WINDOW / mat.nnz > 4.0:
            # the hint was prepared from the ORIGINAL matrix
            hint = hints.get("hybrid_prep")
            prep = (hint if hint is not None and mat is a
                    else prepare_hybrid(mat, prices=prices))
            if prep is None:
                hybrid_wins = False
            elif df:
                # f64 compares estimated costs, not tile counts: dense
                # (8W) and slot (8D) double-float tiles price differently
                ts_tab, spill_ns = cost_tables(
                    mat.n > V2_MAX_N and not striped, True, prices)
                cost_8w = (t8w * dense_tile_ns(True, prices) if t8w
                           else float("inf"))
                cost_8d = (t8d * ts_tab[nw] + spilled * spill_ns if t8d
                           else float("inf"))
                hybrid_wins = prep.cost < 0.85 * min(cost_8w, cost_8d)
            else:
                hybrid_wins = prep.tiles < 0.7 * best
            if (hybrid_wins and prep.spilled <= 0.02 * mat.nnz
                    and prep.tiles * WINDOW <= 6.7e8):
                try:
                    pd = _sell8w_plan(prep.dense_sorted, {})
                    pd["m_rows"] = prep.dense_sorted.m
                    pd["fold_rows"] = prep.fold_rows.astype(INT_DTYPE)
                    sparse = prep.sparse
                    if (df and "sell8w_v2" in pd
                            and "mega_sub_rows" not in pd
                            and "rest_rows" not in pd):
                        # f64 folds by x-extension: the light plan gains a
                        # 1.0-valued entry (row fold_rows[j], column n + j)
                        # per compact heavy row, and the executor appends
                        # the heavy output to x; a windowed dense part
                        # (past V2_MAX_N) folds by the scatter-add
                        pd["fold_planes_ext"] = True
                        sparse = _append_fold_entries(
                            prep.sparse, prep.fold_rows, np.float64)
                    allow_s = min(
                        96.0,
                        max(32.0, 1.5 * prep.ts * WINDOW
                            / max(prep.sparse.nnz, 1)),
                        slot_stream_budget(sparse.vals, prep.nw, df)
                        / max(sparse.nnz, 1))
                    psp = _sell8d_plan(
                        sparse,
                        {**extra, "sell8d_nw": prep.nw,
                         "sell8d_allow": allow_s,
                         "sell8d_striped": striped,
                         "sell8d_max_spill": max_sp})
                    return {"hybrid": (pd, psp),
                            "pad_ratio": prep.tiles * WINDOW / mat.nnz,
                            "value_mode": psp.get("value_mode"),
                            "dense_frac": prep.dense_frac}
                except ValueError:
                    pass
        if t8d and not tried_8d and t8d < 0.7 * t8w:
            try:
                return _sell8d_plan(mat, {**extra, "sell8d_nw": nw,
                                          "sell8d_striped": striped,
                                          "sell8d_max_spill": max_sp})
            except ValueError:
                pass
        return _sell8w_plan(mat, extra)

    try:
        return _plan_windowed(a, {})
    except ValueError:
        # a sprinkle of long-range nonzeros may be all that fails the
        # gate: retry with them on the straggler stream
        a_main, rest, frac = sell8w_fmt.split_stragglers(a)
        if rest is not None and frac <= 0.05:
            try:
                return _plan_windowed(a_main, {"rest_host": rest})
            except ValueError:
                pass
        # the last tile plan: the graph split (hub columns + heavy rows),
        # where every window and slot layout fails
        if (np.dtype(a.dtype) == np.float32
                and hints.get("graph_prep") is None):
            from .formats.graph import prepare_graph_split
            gprep = prepare_graph_split(a, prices=prices)
            if _graph_gate(a, gprep):
                try:
                    return _build_graph_plan(a, gprep, prices)
                except ValueError:
                    pass
    return None


# --------------------------------------------------------------------------
# Placement and binding (device work)
# --------------------------------------------------------------------------

def _host_values(vals):
    """Values as the plan streams them: f64 stays f64, bf16 bits become a
    ``torch.bfloat16`` tensor (the plain plans upcast it a call), the rest
    is f32."""
    v = np.asarray(vals)
    if v.dtype == np.uint16:
        return _bf16.as_torch(v)
    return v if v.dtype == np.float64 else v.astype(np.float32)


def _prepare_rest(rows, cols, vals, device) -> Dict[str, Any]:
    """Straggler stream sorted by row: per-row sums on the compact
    straggler domain (the run length of each row counted here, once),
    then one add into y."""
    rr = np.asarray(rows)
    order = np.argsort(rr, kind="stable")
    rs = rr[order]
    first = np.ones(len(rs), dtype=bool)
    first[1:] = rs[1:] != rs[:-1]
    starts = np.flatnonzero(first)
    return {"uniq": dev_put(rs[first].astype(np.int64), device),
            "lengths": dev_put(np.diff(np.append(starts, len(rs)))
                               .astype(np.int64), device),
            "cols": dev_put(np.asarray(cols)[order].astype(np.int64),
                            device),
            "vals": dev_put(_host_values(vals)[order], device),
            "nseg": len(starts)}


def add_rest(r: Dict[str, Any], x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """y += the straggler stream ``r`` (:func:`_prepare_rest`) times x, in
    place: the products, their per-row sums on the compact domain (a
    fixed-order :func:`torch_csr.segment_sum`), one ``index_add_`` into y
    over distinct rows, one add a row."""
    if not r["nseg"]:
        return y
    prod = r["vals"] * x[r["cols"]]
    return y.index_add_(0, r["uniq"],
                        torch_csr.segment_sum(prod, r["lengths"]))


def _stripe_slices(vis, device) -> Optional[torch.Tensor]:
    """The 1024-row slices a stripe's compact output lands on, as an int64
    tensor on ``device``; None when they are the first len(vis) slices
    (a stripe that touches every slice), which a plain add places."""
    vis = np.asarray(vis, dtype=np.int64)
    if np.array_equal(vis, np.arange(len(vis))):
        return None
    return dev_put(vis, device)


#: plan keys of index arrays (placed as int64) and of value arrays
_INDEX_KEYS = ("fold_rows", "rows", "colidx", "hub_cols",
               "colidx_pad", "row_start", "row_end", "vrow_start",
               "vrow_end", "sub_start", "sub_end", "cols", "chunk_ids",
               "inv_pos", "block_rows", "block_cols")
_VALUE_KEYS = ("vals", "vals_pad")


def _place(plan: Dict[str, Any], device) -> Dict[str, Any]:
    """Host plan → the same plan with its arrays on ``device`` (packs
    become kernel streams).  The v1 SELL-8W pack is host-only: a graph
    plan's heavy row count stays as its ``fold_k``."""
    out: Dict[str, Any] = {}
    for k, v in plan.items():
        if k == "hybrid":
            out[k] = tuple(_place(p, device) for p in v)
        elif k in ("light", "heavy"):
            out[k] = _place(v, device)
        elif k == "sell8d":
            out[k] = sell_ops.prepare_sell(v, device, slot_mode=True)
        elif k == "sell8d_stripes":
            out[k] = [(int(lo), int(hi), _stripe_slices(vis, device),
                       sell_ops.prepare_sell(pk, device, slot_mode=True))
                      for lo, hi, vis, pk in v]
        elif k in ("sell8w_v2", "sell8w_v2w"):
            out[k] = sell_ops.prepare_sell(v, device, slot_mode=False)
        elif k == "dia":
            out[k] = dia_ops.prepare_dia(v, device)
        elif k == "coo2":
            out[k] = coo2_ops.prepare_coo2(v, device)
        elif k in _INDEX_KEYS:
            out[k] = dev_put(np.asarray(v).astype(np.int64), device)
        elif k in _VALUE_KEYS:
            out[k] = dev_put(_host_values(v), device)
        elif k == "blocks":
            b = np.asarray(v)
            out[k] = dev_put(_bf16.as_torch(b) if b.dtype == np.uint16
                             else b, device)
        elif k == "rest_rows":
            out["rest"] = _prepare_rest(v, plan["rest_cols"],
                                        plan["rest_vals"], device)
        elif k == "mega_sub_rows":
            out["mega_fold"] = torch_csr.fold_plan(v, device)
        elif k in ("sell8w", "rest_cols", "rest_vals"):
            continue
        else:
            out[k] = v
    return out


#: the span of the host's whole side of one product: ``spmv()`` with its
#: checks and cast, or a call of the handle's bound closure
PRODUCT = "spmv.product"
STRIPES = "spmv.glue.stripes"

# The handle's glue between the kernels, each op in its span (the kernels'
# outputs are computed before the op is called, outside it).  A closure
# calls these only while spans are live (``profiling.live``, tested inline
# so that tracing off costs a product no extra call) and the bare op
# otherwise.
_fold_add = spanned("spmv.glue.fold", operator.add)
_fold_index_add = spanned("spmv.glue.fold", torch.Tensor.index_add_)
_fold_mega = spanned("spmv.glue.fold", torch_csr.fold_add)
_rest = spanned("spmv.glue.rest", add_rest)
_xext_cat = spanned("spmv.glue.xext", torch.cat)
_hub_ext = spanned("spmv.glue.xext", lambda x, hub: torch.cat([x, x[hub]]))
_perm_gather = spanned("spmv.glue.perm", torch.Tensor.__getitem__)


def _product(fn):
    """The handle's outermost closure: ``fn`` inside the ``spmv.product``
    span, which ``spmv()``, ``h(x)`` and a solver's direct call of
    ``h._bound`` all pass."""
    def product(x):
        if _torch_profiler._is_profiler_enabled or \
                profiling.record is not None:
            with span(PRODUCT):
                return fn(x)
        return fn(x)
    return product


def _extend_x(f_dense, x: torch.Tensor) -> torch.Tensor:
    """Fold by x-extension: x with the dense part's output (its compact
    heavy rows) appended, which the light part of an f64 hybrid reads."""
    cat = (_xext_cat if _torch_profiler._is_profiler_enabled
           or profiling.record is not None else torch.cat)
    return cat([x, f_dense(x)])


def light_part_input(handle: "SpmvHandle", x: torch.Tensor) -> torch.Tensor:
    """The x that the light (slot-mode) part of ``handle``'s hybrid plan
    reads: ``x`` itself, or ``x`` extended by the dense part's output when
    the plan folds by x-extension.  ``x`` is on the handle's device, in its
    type."""
    pd = handle.plan["hybrid"][0]
    if not pd.get("fold_planes_ext"):
        return x
    return _extend_x(_make_bound(handle.method, pd,
                                 pd.get("m_rows", handle.m)), x)


def _graph_fns(method: Method, p: Dict[str, Any], m_rows: int):
    """(x -> the x each part reads, {part: x_part -> y_part}) of a placed
    graph plan.  The heavy part reads x extended by the hub columns and
    gives ``fold_k`` rows; the light part, with its straggler stream, reads
    that vector extended by the heavy output."""
    light = p["light"]["sell8d"]
    fns = {"light": _make_bound(method, p["light"], m_rows)}
    hub = p.get("hub_cols")
    fold_k = 0
    if "heavy" in p:
        fold_k = p["fold_k"]
        heavy = p["heavy"]["sell8w_v2"]
        if heavy.m < fold_k or heavy.n + fold_k != light.n:
            raise ValueError(
                f"graph plan: the heavy stream ({heavy.m} rows over "
                f"{heavy.n} columns) does not feed the light stream's "
                f"{light.n} columns with its {fold_k} rows")
        fns["heavy"] = _make_bound(method, p["heavy"], fold_k)

    def inputs(x):
        traced = (_torch_profiler._is_profiler_enabled
                  or profiling.record is not None)
        if hub is None:
            x_ext = x
        elif traced:
            x_ext = _hub_ext(x, hub)
        else:
            x_ext = torch.cat([x, x[hub]])
        if not fold_k:
            return {"light": x_ext}
        y_heavy = fns["heavy"](x_ext)[:fold_k]
        cat = _xext_cat if traced else torch.cat
        return {"heavy": x_ext, "light": cat([x_ext, y_heavy])}

    return inputs, fns


def graph_part_inputs(handle: "SpmvHandle",
                      x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The x that each part of ``handle``'s graph plan reads: ``"heavy"``
    (x extended by the hub columns) where the plan has heavy rows, and
    ``"light"`` (that vector extended by the heavy output).  ``x`` is on
    the handle's device, in its type."""
    return _graph_fns(handle.method, handle.plan, handle.m)[0](x)


#: the plan keys of SELL tile streams
_SELL_KEYS = ("sell8d", "sell8d_stripes", "sell8w_v2", "sell8w_v2w")


def _sell_fn(p: Dict[str, Any], m_rows: int):
    """``x -> y`` over a placed plan's SELL streams, before its folds."""
    if "sell8d_stripes" not in p:
        st = next(p[k] for k in _SELL_KEYS if k in p)
        return lambda x: sell_ops.sell_spmv(st, x)[:st.m]
    # one slot stream per column stripe on its slice of x (a view); each
    # compact output adds into the 1024-row slices it touched, and y is
    # cut to m_rows once, after the stripes
    parts = p["sell8d_stripes"]
    window = sell8w_fmt.WINDOW
    nsl = max(-(-m_rows // window), 1)

    def striped(x):
        # the span bounds the whole sum, the stripes' kernels nested in it:
        # its self time is the glue
        if _torch_profiler._is_profiler_enabled or \
                profiling.record is not None:
            s = profiling.opening(STRIPES)
            if s is not None:
                with s:
                    return striped(x)
        out = torch.zeros(nsl, window, dtype=x.dtype, device=x.device)
        for lo, hi, vis, st in parts:
            o = sell_ops.sell_spmv(st, x[lo:hi]).view(-1, window)
            if vis is None:
                out[:o.shape[0]] += o
            else:
                # distinct slices: one add a row, in stripe order
                out.index_add_(0, vis, o)
        return out.view(-1)[:m_rows]

    return striped


def _make_bound(method: Method, p: Dict[str, Any], m_rows: int):
    """Bind a placed plan into an ``x -> y`` closure.  Outputs are fresh
    tensors, so the folds add into them in place."""
    if "hybrid" in p:
        # dense row-window part (row mode, compact heavy rows) + scattered
        # remainder (slot mode); the compact dense output folds back with
        # one small scatter-add
        pd, psp = p["hybrid"]
        f2 = _make_bound(method, psp, m_rows)
        f1 = _make_bound(method, pd, pd.get("m_rows", m_rows))
        if pd.get("fold_planes_ext"):
            # f64: the light plan's fold columns gather the heavy output,
            # appended to x (the light stream's n is n + the heavy rows)
            return lambda x: f2(_extend_x(f1, x))
        if "fold_rows" in pd:
            # distinct rows (one a compact heavy row): one add a row
            fr = pd["fold_rows"]

            def fold_rows(x):
                add = (_fold_index_add if _torch_profiler._is_profiler_enabled
                       or profiling.record is not None
                       else torch.Tensor.index_add_)
                return add(f2(x), 0, fr, f1(x))
            return fold_rows

        def fold_sum(x):
            add = (_fold_add if _torch_profiler._is_profiler_enabled
                   or profiling.record is not None else operator.add)
            return add(f1(x), f2(x))
        return fold_sum
    if "graph" in p:
        inputs, fns = _graph_fns(method, p, m_rows)
        light_fn = fns["light"]
        return lambda x: light_fn(inputs(x)["light"])
    if any(k in p for k in _SELL_KEYS):
        inner = _sell_fn(p, m_rows)
        fn = inner
        if "mega_fold" in p:
            # fold virtual sub-row outputs back into their origin rows,
            # which repeat: a fixed-order fold
            fold = p["mega_fold"]

            def fn(x):
                y = inner(x)
                add = (_fold_mega if _torch_profiler._is_profiler_enabled
                       or profiling.record is not None
                       else torch_csr.fold_add)
                return add(y[:m_rows], fold, y[m_rows:])

        if "rest" in p:
            r = p["rest"]
            kern = fn

            def fn(x):
                add = (_rest if _torch_profiler._is_profiler_enabled
                       or profiling.record is not None else add_rest)
                return add(r, x, kern(x))

        return fn
    if "dia" in p:
        d = p["dia"]
        return lambda x: dia_ops.dia_spmv(d, x)
    if "coo2" in p:
        c = p["coo2"]
        return lambda x: coo2_ops.coo2_spmv(c, x)
    if "sub_start" in p:
        return lambda x: torch_csr.balanced2_spmv(
            p["colidx_pad"], p["vals_pad"], p["vrow_start"], p["vrow_end"],
            p["sub_start"], p["sub_end"], x, tile=p["tile"])
    if "colidx_pad" in p:
        if method == Method.BALANCED_YID:
            return lambda x: torch_csr.scan_spmv_global(
                p["colidx_pad"], p["vals_pad"], p["row_start"],
                p["row_end"], x)
        # Balanced, a demoted Balanced2, CSR5's fall-through, the chunked
        # SELL's fall-back
        return lambda x: torch_csr.scan_spmv_tiled(
            p["colidx_pad"], p["vals_pad"], p["row_start"], p["row_end"],
            x, tile=p["tile"])
    # the plain segment sums count their run lengths once, here
    if "cols" in p:
        lens = torch_csr.segment_lengths(p["chunk_ids"], p["nslices"])
        return lambda x: torch_csr.sell_spmv(
            p["cols"], p["vals"], lens, p["inv_pos"], x,
            identity_order=p["identity_order"])
    if "blocks" in p:
        lens = torch_csr.segment_lengths(p["block_rows"], p["nblock_rows"])
        return lambda x: torch_csr.bcsr_spmv(
            p["blocks"], lens, p["block_cols"], x, m=m_rows)
    if method == Method.SERIAL:
        lens = torch_csr.segment_lengths(p["rows"], m_rows)
        return lambda x: torch_csr.segment_sum_spmv(
            lens, p["colidx"], p["vals"], x)
    raise ValueError(f"no executor for method {method} and plan "
                     f"{sorted(p)}")


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------

def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def create_handle(a: CsrMatrix,
                  method: Method = Method.AUTO,
                  nthreads: int = 0,
                  vectorized: VectorizedWay = VectorizedWay.VPU,
                  mtx_token: Optional[str] = None,
                  reorder: Optional[str] = None,
                  warm: bool = False,
                  device="cuda",
                  prices: Optional[Prices] = None) -> SpmvHandle:
    """Inspect the matrix, build the plan, place it on ``device``.

    ``device`` is where the plan lives and where ``spmv`` takes x; it is
    never inferred.  On a CUDA device the plan runs the hand-written
    kernels; on the CPU it runs their plain PyTorch versions.

    ``reorder``: "rcm", "window", "cluster" or "length" permutes rows and
    columns before planning (square matrices only); the handle permutes x
    in and y out on every call, so ``spmv`` keeps its contract.  With
    ``mtx_token`` the permutation is cached on disk
    (``formats/reorder.py:cached_order``).  ``handle.perm`` holds it.

    ``prices``: the table every plan cost is priced with
    (``formats/prices.py``): None is ``REFERENCE``, the JAX package's
    values, which give the JAX planner's routes; ``prices.H100`` is the
    table derived on an H100.

    ``a`` holds float32, float64 or bfloat16 values; y is f64 for f64 and
    f32 otherwise.
    """
    if not (_tiles_ok(a) or a.dtype == torch.bfloat16):
        raise NotImplementedError(
            f"{dtype_name(a.dtype)} values: spmv_tpu_torch takes float32, "
            "float64 or bfloat16 matrices, as the JAX package does")
    dev = _resolve_device(device)
    requested = Method(method)
    a_orig = a
    perm = None
    if reorder is not None:
        from .formats import reorder as reorder_mod
        if a.m != a.n:
            raise ValueError("reorder requires a square matrix")
        if mtx_token:
            perm = reorder_mod.cached_order(a, mtx_token, kind=reorder)
        elif reorder == "rcm":
            perm = reorder_mod.rcm_order(a)
        elif reorder == "window":
            perm = reorder_mod.window_cluster_order(a)
        elif reorder == "cluster":
            perm = reorder_mod.cluster_order(a)
        elif reorder == "length":
            perm = reorder_mod.length_order(a)
        else:
            raise ValueError(f"unknown reorder kind {reorder!r}")
        a, _ = reorder_mod.reorder_symmetric(a, perm)
    resolved = requested
    row_perm = None
    plan_hints: Dict[str, Any] = {}
    if requested == Method.AUTO:
        from .inspector import choose_method
        with span("predeal.inspect"):
            resolved = choose_method(a)
        if (resolved == Method.BALANCED and perm is None
                and 10_000 <= a.nnz and a.n <= 20_000_000):
            with span("predeal.prepare"):
                # heavy-tailed matrices land here only because mega-rows
                # explode the SELL-8W pad estimate: prefer the row-split
                # hybrid on natural order, else a rows-only length sort, else
                # the graph split
                from .formats import reorder as reorder_mod
                from .formats.sell8d import prepare_hybrid
                from .formats.sell8w import estimate_sell8w_tiles, WINDOW
                prep = prepare_hybrid(a, prices=prices)
                if (prep is not None
                        and prep.tiles * WINDOW / a.nnz
                        <= min(32.0, 6.7e8 / a.nnz)
                        and prep.spilled <= 0.02 * a.nnz):
                    resolved = Method.SELL_C_SIGMA   # hybrid in _plan_sell
                    plan_hints["hybrid_prep"] = prep
                else:
                    perm_try = reorder_mod.length_order(a)
                    a_try = reorder_mod.reorder_rows(a, perm_try)
                    est = estimate_sell8w_tiles(a_try) * WINDOW / a.nnz
                    if est <= min(32.0, 6.7e8 / a.nnz):
                        a, row_perm, resolved = (a_try, perm_try,
                                                 Method.SELL_C_SIGMA)
                if resolved == Method.BALANCED and a.dtype == np.float32:
                    # web-graph regime: hub columns + heavy rows
                    # (formats/graph.py), else the tiled scan; the gate takes
                    # f32 only, so no other type prepares the split
                    from .formats.graph import prepare_graph_split
                    gprep = prepare_graph_split(a, prices=prices)
                    if _graph_gate(a, gprep):
                        resolved = Method.SELL_C_SIGMA
                        plan_hints["graph_prep"] = gprep
    if (VectorizedWay(vectorized) == VectorizedWay.MXU
            and resolved in (Method.PARALLEL, Method.SELL_C_SIGMA,
                             Method.CSR5) and a.nnz > 0):
        # MXU: the BCSR block products where the matrix has dense 128×128
        # blocks worth densifying; requested_method records the ask
        from .formats import bcsr as bcsr_fmt
        nblocks, fill = bcsr_fmt.bcsr_profile(a)
        if fill >= 0.02 and nblocks * bcsr_fmt.BLOCK ** 2 * 8 <= 4e9:
            resolved = Method.BCSR
    with span("predeal.build"):
        plan = _build_plan(a, resolved, nthreads, VectorizedWay(vectorized),
                           hints=plan_hints, prices=prices)
    if plan.pop("demoted", False):
        resolved = Method.BALANCED    # the reference's Balanced2 demotion
    with span("predeal.place"):
        placed = _place(plan, dev)
        bound = _make_bound(resolved, placed, a.m)
        if perm is not None:
            # y[perm[i]] = y'[i], so y = y'[inv]: two m-gathers a call
            perm_dev = dev_put(np.asarray(perm).astype(np.int64), dev)
            inv = np.empty_like(perm)
            inv[perm] = np.arange(len(perm))
            inv_dev = dev_put(inv.astype(np.int64), dev)
            bound = _permuted(bound, perm_dev, inv_dev)
        elif row_perm is not None:
            # rows-only reorder: x natural, y back with one m-gather
            inv = np.empty_like(row_perm)
            inv[row_perm] = np.arange(len(row_perm))
            inv_dev = dev_put(inv.astype(np.int64), dev)
            bound = _permuted(bound, None, inv_dev)
        bound = _product(bound)
    h = SpmvHandle(
        method=resolved, requested_method=requested,
        dtype=a.dtype, m=a.m, n=a.n, nnz=a.nnz,
        nthreads=nthreads, vectorized=VectorizedWay(vectorized),
        mtx_token=mtx_token, device=dev, plan=placed, _bound=bound,
        perm=perm, _matrix=a_orig, _reorder=reorder, _prices=prices)
    if warm:
        spmv(h, torch.zeros(a.n, dtype=_torch_dtype(h.dtype), device=dev))
    return h


def _permuted(inner, perm_dev, inv_dev):
    """``inner`` between the reorder's gathers: x by ``perm_dev`` (None: x
    stays natural) and y by ``inv_dev``."""
    def permuted(x):
        if _torch_profiler._is_profiler_enabled or \
                profiling.record is not None:
            xp = x if perm_dev is None else _perm_gather(x, perm_dev)
            return _perm_gather(inner(xp), inv_dev)
        return inner(x if perm_dev is None else x[perm_dev])[inv_dev]
    return permuted


def _torch_dtype(dtype) -> torch.dtype:
    """The type x and y take for a matrix of ``dtype``: f64 for f64, f32
    for f32 and bf16."""
    return torch.float64 if dtype == np.float64 else torch.float32


def spmv(handle: SpmvHandle, x) -> torch.Tensor:
    """Execute y = A @ x.  ``x`` is a tensor on ``handle.device`` (a numpy
    array is copied there), cast to f64 for an f64 matrix and to f32
    otherwise (a bf16 x upcasts exactly); the result is a tensor of that
    type there.  The checks, the cast and the product lie in one
    ``spmv.product`` span."""
    if _torch_profiler._is_profiler_enabled or profiling.record is not None:
        s = profiling.opening(PRODUCT)
        if s is not None:
            with s:
                return spmv(handle, x)
    if handle._bound is None:
        raise RuntimeError("handle was cleared/destroyed; create a new one")
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x), device=handle.device)
    if x.shape != (handle.n,):
        raise ValueError(f"x has shape {tuple(x.shape)}, expected "
                         f"({handle.n},)")
    if x.device != handle.device:
        raise ValueError(f"x is on {x.device}, the handle on "
                         f"{handle.device}")
    return handle._bound(x.to(_torch_dtype(handle.dtype)).contiguous())


# -- reference-parity spellings ---------------------------------------------

def spmv_create_handle_all_in_one(m: int, n: int, rowptr, colidx, vals,
                                  nthreads: int = 0,
                                  method: Method = Method.AUTO,
                                  dtype=None,
                                  vectorized: VectorizedWay = VectorizedWay.VPU,
                                  mtx_token: Optional[str] = None,
                                  device="cuda") -> SpmvHandle:
    """Raw-array parity constructor (include/spmv.h:41-52); ``dtype`` may
    be ``torch.bfloat16``."""
    a = CsrMatrix(m, n, rowptr, colidx, vals)
    if dtype is not None:
        a = a.astype(dtype)
    return create_handle(a, method=method, nthreads=nthreads,
                         vectorized=vectorized, mtx_token=mtx_token,
                         device=device)


def spmv_clear_handle(handle: SpmvHandle) -> None:
    if handle is not None:
        handle.clear()


def spmv_destroy_handle(handle: SpmvHandle) -> None:
    if handle is not None:
        handle.destroy()


#: the reference spells it "destory" (include/spmv.h:19) — keep the alias
spmv_destory_handle = spmv_destroy_handle
