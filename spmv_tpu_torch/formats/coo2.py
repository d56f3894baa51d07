"""COO2: the two-pass windowed format for scattered matrices (a copy of
``spmv_tpu/formats/coo2.py``; its packs are pinned bit-identical by
``tests/test_torch_coo2.py``).

The reference's CSR5 exists because neither row-major SELL nor plain CSR
balances scattered matrices.  COO2 decouples the gather from the row sums
with an intermediate product stream:

* **Pass 1 (gather)**: nonzeros sorted by (super-slice, column-window,
  slice, row), window-major within a group of K row-slices, so every
  (8,128) tile's columns share ONE 1024-column window while padding stays a
  few %.  The pass-1 kernel (``ops/coo2.py``) writes one product per slot,
  in tile order.
* **Pass 2 (reduce)**: summing each row's products is itself an SpMV,
  ``y = R @ p``, where R is the m × N_positions 0/1 matrix mapping product
  positions to rows.  R's columns are position-clustered by construction
  (each slice's products sit in short contiguous runs), so R packs well as
  SELL-8W and pass 2 runs the SELL row-mode kernel in its binary mode with
  x := the product stream.  R's "values" are 1.0 (padding 0.0).

Everything is decided at pack time; execution is two kernel calls.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import native
from ..types import CsrMatrix, INT_DTYPE
from . import _bf16
from .sell8w import Sell8W, pack_sell8w, pairs_lower_bound, LANES, SUB, WINDOW

__all__ = ["Coo2", "pack_coo2", "packs"]

#: packs made by each path: the fused C++ pipeline ("native"), the numpy
#: sort with the C++ placer ("native_place"), and the numpy sort with the
#: Python placer ("python", minutes at millions of nonzeros)
packs = {"native": 0, "native_place": 0, "python": 0}


@dataclasses.dataclass(frozen=True)
class Coo2:
    m: int
    n: int
    nnz_stored: int
    # pass 1 (gather) tiles:
    ntiles: int
    window_ids: np.ndarray    # (ntiles,) int32
    meta: np.ndarray          # (ntiles, 8, 128) int16 (s<<7|r per slot)
    vals: np.ndarray          # (ntiles, 8, 128) float32 (0 = padding)
    # pass 2 (reduce): R packed as SELL-8W over the product stream
    reduce_plan: Sell8W

    @property
    def pad_ratio_pass1(self) -> float:
        return self.ntiles * WINDOW / max(self.nnz_stored, 1)

    @property
    def pad_ratio_pass2(self) -> float:
        return self.reduce_plan.pad_ratio


def _place_tiles(order_s, order_r, order_v, group_bounds):
    """Greedy slot placement per window-group.

    Elements of one group share a window; a slot (i, j) is free-form (no
    lane binding: rows are handled by pass 2) under the same
    per-(sublane, residue) staging-consistency constraint as SELL-8W.
    Returns (meta tiles, vals tiles, windows, positions per element).
    """
    tiles_meta, tiles_vals, tiles_w = [], [], []
    positions = np.empty(len(order_s), dtype=np.int64)
    for w, lo, hi in group_bounds:
        pending = list(range(lo, hi))
        while pending:
            stab = np.full((SUB, LANES), -1, dtype=np.int16)
            rslot = np.zeros((SUB, LANES), dtype=np.int16)
            vtile = np.zeros((SUB, LANES), dtype=np.float32)
            next_free = np.zeros(SUB, dtype=np.int64)  # next lane per sublane
            overflow = []
            t_idx = len(tiles_meta)
            for e in pending:
                s_e, r_e = int(order_s[e]), int(order_r[e])
                placed = False
                for i in range(SUB):
                    if next_free[i] < LANES and stab[i, r_e] in (-1, s_e):
                        j = int(next_free[i])
                        next_free[i] += 1
                        stab[i, r_e] = s_e
                        rslot[i, j] = r_e
                        vtile[i, j] = order_v[e]
                        positions[e] = t_idx * WINDOW + i * LANES + j
                        placed = True
                        break
                if not placed:
                    overflow.append(e)
            tiles_meta.append(
                ((np.maximum(stab, 0) << 7) | rslot).astype(np.int16))
            tiles_vals.append(vtile)
            tiles_w.append(w)
            pending = overflow
    return tiles_meta, tiles_vals, tiles_w, positions


def _coo2(a: CsrMatrix, window_ids, meta, vals, r_mat, max_pad2) -> Coo2:
    return Coo2(m=a.m, n=a.n, nnz_stored=a.nnz, ntiles=len(window_ids),
                window_ids=np.asarray(window_ids, dtype=INT_DTYPE),
                meta=meta, vals=vals,
                reduce_plan=pack_sell8w(r_mat, max_pad_ratio=max_pad2))


def pack_coo2(a: CsrMatrix, super_slices: int = 40,
              max_pad2: float = None) -> Coo2:
    """Pack for the two-pass kernels.  ``super_slices`` = K row-slices per
    sort group (larger K → denser pass-1 tiles, slightly worse pass-2
    clustering).

    ``max_pad2`` gates the pass-2 (reduce) padding: the R reduction pays at
    least one tile per (row-slice, column-window) pair, so matrices whose
    rows scatter across many windows (under ~8 nnz per row per window)
    explode pass 2; raise ValueError so the handle falls back (the frontier
    where the reference's CSR5 tiles degenerate to one row per tile).
    f32 values only (``_bf16.refuse``; the planner packs f32)."""
    _bf16.refuse(a.vals, "pack_coo2")
    if a.nnz == 0:
        raise ValueError("empty matrix: use another method")
    if max_pad2 is not None:
        # sortless pre-gate (same bound as below) before any heavy work
        lb = pairs_lower_bound(a)
        if lb and lb * WINDOW / a.nnz > max_pad2:
            raise ValueError(
                f"coo2 pass-2 padding lower bound "
                f"{lb * WINDOW / a.nnz:.1f} exceeds {max_pad2}")
    fused = native.coo2_pack_all_native(a.m, a.n, a.rowptr, a.colidx,
                                        a.vals, super_slices)
    if fused is not None:
        window_arr, meta_arr, vals_arr, r_rowptr, r_colidx = fused
        r_mat = CsrMatrix(a.m, len(window_arr) * WINDOW, r_rowptr, r_colidx,
                          np.ones(a.nnz, dtype=np.float32))
        out = _coo2(a, window_arr, meta_arr, vals_arr, r_mat, max_pad2)
        packs["native"] += 1
        return out
    if max_pad2 is not None:
        # cheap estimate: distinct (slice, window) pairs bound the R tiles
        rows_e = np.repeat(np.arange(a.m, dtype=np.int64), a.row_lengths)
        pairs = np.unique(
            (rows_e // LANES) * (a.n // WINDOW + 2)
            + a.colidx.astype(np.int64) // WINDOW).size
        if pairs * WINDOW / a.nnz > max_pad2:
            raise ValueError(
                f"coo2 pass-2 padding estimate "
                f"{pairs * WINDOW / a.nnz:.1f} exceeds {max_pad2}")
    rows = np.repeat(np.arange(a.m, dtype=np.int64), a.row_lengths)
    cols = a.colidx.astype(np.int64)
    sl = rows // LANES
    sup = sl // super_slices
    w = cols // WINDOW
    s_in = ((cols % WINDOW) // LANES).astype(np.int16)
    r_in = (cols % LANES).astype(np.int16)
    vals = a.vals.astype(np.float32)

    # single fused key (sup, w, rows): row order within a group subsumes
    # the sl key since sl = rows // LANES
    nw = int(w.max()) + 2
    nsup = int(sup.max()) + 1
    if nsup * nw * a.m <= (1 << 62):
        gkey = sup * nw + w
        order = np.argsort(gkey * a.m + rows, kind="stable")
        gkey_o = gkey[order]
    else:
        order = np.lexsort((rows, sl, w, sup))
        gkey_o = (sup * nw + w)[order]
    rows_o = rows[order]
    w_o = w[order]
    s_o, r_o, v_o = s_in[order], r_in[order], vals[order]

    # group bounds over (super, window)
    bounds_idx = np.concatenate([[0], np.nonzero(np.diff(gkey_o))[0] + 1,
                                 [len(gkey_o)]])
    g_lo = bounds_idx[:-1].astype(np.int64)
    g_hi = bounds_idx[1:].astype(np.int64)
    g_w = w_o[g_lo].astype(np.int64)

    placed = native.coo2_place_native(s_o, r_o, v_o, g_w, g_lo, g_hi)
    if placed is not None:
        window_arr, meta_arr, vals_arr, positions = placed
        path = "native_place"
    else:
        group_bounds = [(int(g_w[b]), int(g_lo[b]), int(g_hi[b]))
                        for b in range(len(g_lo))]
        tiles_meta, tiles_vals, window_arr, positions = _place_tiles(
            s_o, r_o, v_o, group_bounds)
        meta_arr, vals_arr = np.stack(tiles_meta), np.stack(tiles_vals)
        path = "python"
    # R: row r ← its product positions (placement keeps no order within a
    # row, so from_coo sorts them)
    r_mat = CsrMatrix.from_coo(
        a.m, len(window_arr) * WINDOW, rows_o.astype(INT_DTYPE),
        positions.astype(INT_DTYPE),
        np.ones(len(positions), dtype=np.float32), sum_duplicates=False)
    # the gate holds on the actual reduce pack (pack_sell8w raises), not
    # just on the pairs estimate, which is a lower bound
    out = _coo2(a, window_arr, meta_arr, vals_arr, r_mat, max_pad2)
    packs[path] += 1
    return out
