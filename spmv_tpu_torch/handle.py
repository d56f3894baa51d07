"""Handle lifecycle + AUTO dispatch for the f32 main path (the port of
``spmv_tpu/handle.py``).

``create_handle`` inspects the matrix and builds a host-side plan (numpy
packs, routed exactly as the JAX package routes on a TPU), places it on
``device``, and binds an ``x -> y`` closure; ``spmv`` then runs only device
work.  Planning does not depend on the device: the CPU runs the same plans
as the card, through each kernel's plain PyTorch version, so the CPU tests
cover the plans the card runs.

Ported plans (the slice the bench's f32 families run):

=================  ==========================================================
DIA                ``ops/dia.py`` (K3; also the JAX package's XLA DIA plan)
SELL-8W v2 rows    ``ops/sell.py`` row mode (K1), with the mega-row fold
SELL-8D slots      ``ops/sell.py`` slot mode (K1), nw 1/2/4/8, cell_w
row-split hybrid   8W heavy rows + 8D light rows + fold scatter-add
stragglers         compact per-row sums + one scatter-add (plain PyTorch)
Serial             gather + scatter-add (plain PyTorch, AUTO's nnz < 10k)
=================  ==========================================================

Everything else raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from .types import CsrMatrix, Method, VectorizedWay, METHOD_NAMES, INT_DTYPE
from .formats import dia as dia_fmt, sell8w as sell8w_fmt
from .ops import dia as dia_ops, sell as sell_ops
from .ops.sell import V2_MAX_N
from .ops.torch_csr import segment_sum_spmv
from .utils.profiling import dev_put

__all__ = [
    "SpmvHandle",
    "create_handle",
    "spmv",
    "spmv_create_handle_all_in_one",
    "spmv_clear_handle",
    "spmv_destory_handle",
    "spmv_destroy_handle",
]


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to spmv_tpu_torch yet (ROADMAP.md, "
        f"'Next slices', item {item})")


# --------------------------------------------------------------------------
# Handle
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SpmvHandle:
    """Inspect-once/execute-many handle (reference ``spmv_Handle``,
    spmv_Defines.h:44-68)."""

    method: Method               # resolved (AUTO → concrete)
    requested_method: Method
    dtype: np.dtype
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
    _matrix: Any = None          # host CsrMatrix (kept until destroy)

    def __call__(self, x) -> torch.Tensor:
        return spmv(self, x)

    @property
    def method_name(self) -> str:
        return METHOD_NAMES[self.method]

    def __repr__(self) -> str:
        return (f"SpmvHandle({self.method_name}, {self.m}x{self.n}, "
                f"nnz={self.nnz}, dtype={np.dtype(self.dtype).name}, "
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
                              mtx_token=self.mtx_token, device=self.device)
        self.method = fresh.method
        self.requested_method = req
        self.plan = fresh.plan
        self._bound = fresh._bound
        return self

    def destroy(self) -> None:
        """End the lifecycle (reference spmv_destory_handle, spmv.h:19)."""
        self.clear()
        self._matrix = None
        self._cleared = True


def plan_kind(plan: Dict[str, Any]) -> str:
    """Short name of a (host or placed) plan's shape."""
    if "hybrid" in plan:
        return "hybrid(8w+8d)"
    for key, name in (("sell8d", "sell8d"), ("sell8w_v2", "sell8w_v2"),
                      ("dia", "dia")):
        if key in plan:
            return name + ("+rest" if ("rest_rows" in plan
                                       or "rest" in plan) else "")
    return "serial" if "rows" in plan else "none"


# --------------------------------------------------------------------------
# Planning (host only: numpy packs, no device)
# --------------------------------------------------------------------------

def _pad_allow(soft_cap: float, mem_cap: float, floor: float = 3.0) -> float:
    """Pad allowance = min(soft_cap, mem_cap), with a convenience floor that
    never overrides the memory cap (handle.py of the JAX package)."""
    return min(max(floor, min(soft_cap, mem_cap)), mem_cap)


def _build_plan(a: CsrMatrix, method: Method, nthreads: int,
                vectorized: VectorizedWay = VectorizedWay.VPU,
                hints: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The JAX planner's f32 branches, as it routes on a TPU."""
    if method in (Method.SELL_C_SIGMA, Method.PARALLEL):
        if vectorized == VectorizedWay.NONE:
            raise _not_ported("the XLA chunked-SELL plan "
                              "(VectorizedWay.NONE)", 5)
        if a.n > V2_MAX_N:
            raise _not_ported("SELL tiers for n > 2M (K5-K7, column "
                              "stripes, sell8w_v2w)", 3)
        return _plan_sell(a, hints or {})
    if method == Method.SERIAL:
        return {
            "rows": np.repeat(np.arange(a.m, dtype=INT_DTYPE),
                              a.row_lengths),
            "colidx": a.colidx,
            "vals": a.vals,
        }
    if method == Method.DIA:
        # one plan covers the JAX package's Pallas and XLA DIA plans: any
        # ndiags the profitability gate admits, any m and n
        ndiags, fill = dia_fmt.dia_profile(a)
        if a.nnz and (fill < 0.02 or ndiags > 4096):
            raise ValueError(
                f"DIA unprofitable: {ndiags} diagonals at fill {fill:.3f} "
                f"(would stream {ndiags * a.m * 4 / 1e6:.0f} MB per exec)")
        d = dia_fmt.pack_dia(a)
        return {"dia": d, "fill": d.fill,
                "offsets": tuple(int(o) for o in d.offsets), "n": a.n}
    if method == Method.CSR5:
        raise _not_ported("Method.CSR5 (the two-pass COO2 plan, K8)", 4)
    if method == Method.BCSR:
        raise _not_ported("Method.BCSR", 5)
    raise _not_ported(f"{METHOD_NAMES.get(method, method)}", 5)


def _plan_sell(a: CsrMatrix, hints: Dict[str, Any]) -> Dict[str, Any]:
    """SELL_C_SIGMA / PARALLEL on f32 with n ≤ V2_MAX_N: row mode
    (SELL-8W v2) vs slot mode (SELL-8D) vs the row-split hybrid, by
    estimated tile count — the JAX planner's ``_plan_windowed`` ladder."""
    from .formats.sell8d import (estimate_sell8d_auto, pack_sell8d,
                                 prepare_hybrid, slot_stream_budget)
    WINDOW = sell8w_fmt.WINDOW

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
        mem_cap = slot_stream_budget(mat.vals, nw, False) / max(mat.nnz, 1)
        allow = extra.get("sell8d_allow", _pad_allow(32.0, mem_cap))
        packed, rest8d = pack_sell8d(
            mat, max_pad_ratio=allow, nw=nw, g="auto",
            max_spill=extra.get("sell8d_max_spill", 0.02), cell_w=nw > 1)
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
        allow = _pad_allow(32.0, 6.7e8 / max(mat.nnz, 1))
        packed = sell8w_fmt.pack_sell8w(mat, max_pad_ratio=allow)
        v2 = sell8w_fmt.plan_v2(packed)
        plan = {"sell8w": packed, "pad_ratio": packed.pad_ratio,
                "value_mode": v2.value_mode, "sell8w_v2": v2}
        extra = dict(extra)
        rest_host = extra.pop("rest_host", None)
        plan.update(extra)
        return _finish_rest(plan, [rest_host])

    def _plan_windowed(mat, extra):
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
        max_sp = 0.02
        t8d, _cap, spilled, nw = estimate_sell8d_auto(mat, nw=None,
                                                      max_spill=max_sp)
        if spilled > max_sp * mat.nnz:
            t8d = 0                       # 8D alone not viable
        tried_8d = False
        if t8d and t8d * WINDOW / mat.nnz <= 4.5:
            # clearly good slot-mode pack: skip the row-mode estimate
            try:
                return _sell8d_plan(mat, {**extra, "sell8d_nw": nw,
                                          "sell8d_max_spill": max_sp})
            except ValueError:
                tried_8d = True
        t8w = sell8w_fmt.estimate_sell8w_tiles(mat)
        best = min(t for t in (t8w, t8d) if t) if (t8w or t8d) else 0
        if best and best * WINDOW / mat.nnz > 4.0:
            # the hint was prepared from the ORIGINAL matrix
            hint = hints.get("hybrid_prep")
            prep = (hint if hint is not None and mat is a
                    else prepare_hybrid(mat))
            if (prep is not None and prep.tiles < 0.7 * best
                    and prep.spilled <= 0.02 * mat.nnz
                    and prep.tiles * WINDOW <= 6.7e8):
                try:
                    pd = _sell8w_plan(prep.dense_sorted, {})
                    pd["m_rows"] = prep.dense_sorted.m
                    pd["fold_rows"] = prep.fold_rows.astype(INT_DTYPE)
                    allow_s = min(
                        96.0,
                        max(32.0, 1.5 * prep.ts * WINDOW
                            / max(prep.sparse.nnz, 1)),
                        slot_stream_budget(prep.sparse.vals, prep.nw,
                                           False)
                        / max(prep.sparse.nnz, 1))
                    psp = _sell8d_plan(
                        prep.sparse,
                        {**extra, "sell8d_nw": prep.nw,
                         "sell8d_allow": allow_s,
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
    raise _not_ported("no SELL tile plan fits this matrix: the graph "
                      "plan and the XLA chunked-SELL/scan fall-through", 2)


# --------------------------------------------------------------------------
# Placement and binding (device work)
# --------------------------------------------------------------------------

def _prepare_rest(rows, cols, vals, device) -> Dict[str, Any]:
    """Straggler stream sorted by row: per-row sums on the compact
    straggler domain, then one scatter-add into y."""
    rr = np.asarray(rows)
    order = np.argsort(rr, kind="stable")
    rs = rr[order]
    first = np.ones(len(rs), dtype=bool)
    first[1:] = rs[1:] != rs[:-1]
    seg = np.cumsum(first) - 1
    return {"uniq": dev_put(rs[first].astype(np.int64), device),
            "seg": dev_put(seg.astype(np.int64), device),
            "cols": dev_put(np.asarray(cols)[order].astype(np.int64),
                            device),
            "vals": dev_put(np.asarray(vals, np.float32)[order], device),
            "nseg": int(seg[-1]) + 1 if len(seg) else 0}


def _place(plan: Dict[str, Any], device) -> Dict[str, Any]:
    """Host plan → the same plan with its arrays on ``device`` (packs
    become kernel streams).  The v1 SELL-8W pack is host-only."""
    out: Dict[str, Any] = {}
    for k, v in plan.items():
        if k == "hybrid":
            out[k] = tuple(_place(p, device) for p in v)
        elif k == "sell8d":
            out[k] = sell_ops.prepare_sell(v, device, slot_mode=True)
        elif k == "sell8w_v2":
            out[k] = sell_ops.prepare_sell(v, device, slot_mode=False)
        elif k == "dia":
            out[k] = dia_ops.prepare_dia(v, device)
        elif k in ("mega_sub_rows", "fold_rows", "rows", "colidx"):
            out[k] = dev_put(np.asarray(v).astype(np.int64), device)
        elif k == "vals":
            out[k] = dev_put(np.asarray(v, np.float32), device)
        elif k == "rest_rows":
            out["rest"] = _prepare_rest(v, plan["rest_cols"],
                                        plan["rest_vals"], device)
        elif k in ("sell8w", "rest_cols", "rest_vals"):
            continue
        else:
            out[k] = v
    return out


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
        if "fold_rows" in pd:
            fr = pd["fold_rows"]
            return lambda x: f2(x).index_add_(0, fr, f1(x))
        return lambda x: f1(x) + f2(x)
    if "sell8d" in p or "sell8w_v2" in p:
        st = p["sell8d"] if "sell8d" in p else p["sell8w_v2"]

        def inner(x):
            return sell_ops.sell_spmv(st, x)[:st.m]

        fn = inner
        if "mega_sub_rows" in p:
            # fold virtual sub-row outputs back into their origin rows
            sub = p["mega_sub_rows"]

            def fn(x):
                y = inner(x)
                return y[:m_rows].index_add_(0, sub, y[m_rows:])

        if "rest" in p:
            r = p["rest"]
            kern = fn

            def fn(x):
                prod = r["vals"] * x[r["cols"]]
                sums = torch.zeros(max(r["nseg"], 1), dtype=torch.float32,
                                   device=x.device).index_add_(
                                       0, r["seg"], prod)
                return kern(x).index_add_(0, r["uniq"], sums[:r["nseg"]])

        return fn
    if "dia" in p:
        d = p["dia"]
        return lambda x: dia_ops.dia_spmv(d, x)
    if method == Method.SERIAL:
        return lambda x: segment_sum_spmv(p["rows"], p["colidx"],
                                          p["vals"], x, m=m_rows)
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
                  device="cuda") -> SpmvHandle:
    """Inspect the matrix, build the plan, place it on ``device``.

    ``device`` is where the plan lives and where ``spmv`` takes x; it is
    never inferred.  On a CUDA device the plan runs the hand-written
    kernels; on the CPU it runs their plain PyTorch versions.
    """
    if reorder is not None:
        raise _not_ported("create_handle(reorder=...)", 5)
    if np.dtype(a.dtype) != np.dtype(np.float32):
        raise _not_ported(f"{np.dtype(a.dtype).name} input (the "
                          "double-float kernels K2, K4)", 1)
    dev = _resolve_device(device)
    requested = Method(method)
    resolved = requested
    row_perm = None
    plan_hints: Dict[str, Any] = {}
    a_orig = a
    if requested == Method.AUTO:
        from .inspector import choose_method
        resolved = choose_method(a)
        if (resolved == Method.BALANCED
                and 10_000 <= a.nnz and a.n <= 20_000_000):
            # heavy-tailed matrices land here only because mega-rows
            # explode the SELL-8W pad estimate: prefer the row-split
            # hybrid on natural order, else a rows-only length sort
            from .formats import reorder as reorder_mod
            from .formats.sell8d import prepare_hybrid
            from .formats.sell8w import estimate_sell8w_tiles, WINDOW
            prep = prepare_hybrid(a)
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
        if resolved == Method.BALANCED:
            raise _not_ported("AUTO's graph rung and the Balanced scan "
                              "plan it falls back to", 2)
    if (VectorizedWay(vectorized) == VectorizedWay.MXU
            and resolved in (Method.PARALLEL, Method.SELL_C_SIGMA,
                             Method.CSR5) and a.nnz > 0):
        from .formats import bcsr as bcsr_fmt
        nblocks, fill = bcsr_fmt.bcsr_profile(a)
        if fill >= 0.02 and nblocks * bcsr_fmt.BLOCK ** 2 * 8 <= 4e9:
            raise _not_ported("VectorizedWay.MXU (the BCSR plan)", 5)
    plan = _build_plan(a, resolved, nthreads, VectorizedWay(vectorized),
                       hints=plan_hints)
    placed = _place(plan, dev)
    bound = _make_bound(resolved, placed, a.m)
    if row_perm is not None:
        # rows-only reorder: x natural, y back with one m-gather
        inv = np.empty_like(row_perm)
        inv[row_perm] = np.arange(len(row_perm))
        inv_dev = dev_put(inv.astype(np.int64), dev)
        inner = bound
        bound = lambda x: inner(x)[inv_dev]     # noqa: E731
    h = SpmvHandle(
        method=resolved, requested_method=requested,
        dtype=np.dtype(a.dtype), m=a.m, n=a.n, nnz=a.nnz,
        nthreads=nthreads, vectorized=VectorizedWay(vectorized),
        mtx_token=mtx_token, device=dev, plan=placed, _bound=bound,
        _matrix=a_orig)
    if warm:
        spmv(h, torch.zeros(a.n, dtype=torch.float32, device=dev))
    return h


def spmv(handle: SpmvHandle, x) -> torch.Tensor:
    """Execute y = A @ x.  ``x`` is a tensor on ``handle.device`` (a numpy
    array is copied there); the result is a float32 tensor there."""
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
    return handle._bound(x.to(torch.float32).contiguous())


# -- reference-parity spellings ---------------------------------------------

def spmv_create_handle_all_in_one(m: int, n: int, rowptr, colidx, vals,
                                  nthreads: int = 0,
                                  method: Method = Method.AUTO,
                                  dtype=None,
                                  vectorized: VectorizedWay = VectorizedWay.VPU,
                                  mtx_token: Optional[str] = None,
                                  device="cuda") -> SpmvHandle:
    """Raw-array parity constructor (include/spmv.h:41-52)."""
    vals = np.asarray(vals)
    if dtype is not None:
        vals = vals.astype(dtype)
    a = CsrMatrix(m, n, rowptr, colidx, vals)
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
