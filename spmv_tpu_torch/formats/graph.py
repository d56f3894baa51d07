"""Graph tier: the hub-column / heavy-row split for web-graph matrices
(the port's copy of ``spmv_tpu/formats/graph.py``; the mesh's graph plan
builds on it).  Its costs come from a price table
(:mod:`.prices`): by default the JAX package's, so the port routes as the
reference does.  The figures quoted below were measured by the JAX package
on its matrices and, where they are times, on the TPU.

Ultra-sparse power-law graphs (webbase-shaped: ~2-3 nnz/row, crawl
locality plus popular "hub" columns) defeat every single-format plan
(measured, 1M-row webbase synthetic):

* SELL-8D slot mode: the hub links scatter each 1024-row slice across
  hundreds of column windows → (slice, bundle) pairs floor pad ~105;
* the row-split hybrid: length-sorting the heavy rows destroys their crawl
  locality (each compacted slice mixes rows from everywhere → every slice
  touches every window) → pad ~77;
* XLA scan plans: the TPU's gather floor (PERFNOTES.md).

The split that works (measured est. pad ~18 on the same matrix, 4-6x
better, all parts riding Pallas kernels):

1. **Hub columns** (degree ≥ max(hub_min_count, 3x the mean) — a few
   thousand columns holding 15-20% of nnz, see ``_hub_columns``) are
   REMAPPED to a compact range appended after n; the executor
   builds ``x_ext = concat(x, x[hub_cols])`` per call (a K-element
   gather).  Scattered hub references collapse into ≤ K/1024
   extra windows shared by BOTH parts (x_ext's prefix is x, so non-hub
   ids index it unchanged).
2. **Heavy rows** (≥ R nnz, R scanned) are compacted in NATURAL order —
   preserving crawl locality, where a length sort interleaves rows from
   everywhere (measured 38k vs 195k-tile packs) — then mega-rows are cut
   into column-contiguous sub-rows (``split_megarows`` with a LOCAL
   max_len ≈ 32, not the global 8·nwin default: a 4k-link crawl row has
   ~700 links per window and must split to fill sublanes; measured
   38k → 11.7k tiles).  Packed as SELL-8W v2; output folds back with ONE
   combined scatter-add over all compact+sub rows.
3. **Light rows** (the 1-3-link tail, 80% crawl-local) ride SELL-8D
   bundles in natural order over the remapped columns.

Reference analog: this is the matrix-structure problem METIS partitioning
solves for the reference at OPT_LEVEL=3 (HyperGraphInterface.cpp:59-147) —
re-solved TPU-first as a column/row stream split instead of a global
reorder, because a full m-element permutation gather per exec costs more
than the kernels themselves at m = 1M (PERFNOTES gather floor).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..types import CsrMatrix
from .sell8w import WINDOW, estimate_sell8w_tiles, split_megarows
from .prices import Prices, table as price_table
from .sell8d import estimate_sell8d_auto, palette_entry_count

__all__ = ["GraphPrep", "prepare_graph_split"]


@dataclasses.dataclass(frozen=True)
class GraphPrep:
    """Prepared parts + estimates for the graph-split plan."""

    hub_cols: Optional[np.ndarray]   # (K,) original column ids, or None
    n_ext: int                       # a.n + K
    heavy: Optional[CsrMatrix]       # compact natural + mega-split rows
    fold_rows: Optional[np.ndarray]  # heavy row i → original row (len m2)
    light: CsrMatrix                 # full-m light remainder
    t_heavy: int                     # SELL-8W tile estimate
    t_light: int                     # SELL-8D tile estimate
    spilled: int                     # light estimated straggler nnz
    nw: int                          # light bundle width
    cost: float                      # calibrated ns estimate per exec

    @property
    def tiles(self) -> int:
        return self.t_heavy + self.t_light

    def pad_ratio(self, nnz: int) -> float:
        return self.tiles * WINDOW / max(nnz, 1)


def _hub_columns(a: CsrMatrix, min_count: int, max_hubs: int):
    """Column ids whose degree makes them worth compacting (None if none)."""
    cc = np.bincount(a.colidx, minlength=a.n)
    mean = a.nnz / max(a.n, 1)
    thresh = max(min_count, int(3 * mean))
    hubs = np.nonzero(cc >= thresh)[0]
    if len(hubs) == 0:
        return None
    if len(hubs) > max_hubs:
        order = np.argsort(cc[hubs])[::-1]
        hubs = np.sort(hubs[order[:max_hubs]])
    return hubs.astype(np.int64)


def prepare_graph_split(a: CsrMatrix,
                        row_thresholds=(8, 16, 32),
                        mega_lens=(32, 64),
                        hub_min_count: int = 8,
                        hub_max: int = 65536,
                        prices: Optional[Prices] = None
                        ) -> Optional[GraphPrep]:
    """Build the graph-split parts, scanning the heavy-row threshold R and
    the mega-row split length.

    Returns None when the matrix has no exploitable split (no hubs AND no
    heavy rows — then the plain 8D/hybrid ladder is already optimal).
    The caller gates on ``cost``/``pad_ratio`` — this function only builds
    the best candidate under the cost model, priced by ``prices``
    (None is ``REFERENCE``).
    """
    if a.nnz == 0 or a.m == 0:
        return None
    p = price_table(prices)
    tile_ns = Prices.by_nw(p.tile_ns)
    hub_cols = _hub_columns(a, hub_min_count, hub_max)
    k = len(hub_cols) if hub_cols is not None else 0
    n_ext = a.n + k
    lens = a.row_lengths.astype(np.int64)
    rows = np.repeat(np.arange(a.m, dtype=np.int64), lens)
    colidx = np.asarray(a.colidx)
    vals = np.asarray(a.vals)
    if hub_cols is not None:
        remap = np.arange(a.n, dtype=np.int64)
        remap[hub_cols] = a.n + np.arange(k)
        cols_r = remap[colidx]
        # restore within-row column order (hub ids jumped to the end):
        # stable partition per row so mega-split chunks stay
        # column-contiguous — mixed chunks would straddle windows
        is_hub = cols_r >= a.n
        order = np.argsort(rows * np.int64(2) + is_hub, kind="stable")
        cols_r = cols_r[order]
        vals = vals[order]
    else:
        cols_r = colidx.astype(np.int64)

    best = None

    # None = light-only candidate (hub remap alone may fix the layout).
    # The threshold candidates are independent and dominated by GIL-
    # releasing work (native stats, big fancy indexing), so they evaluate
    # on a thread pool — webbase predeal is host-bound python (round-4
    # VERDICT item 5: cut it below 3 s).
    def _evaluate(r_thresh):
        if r_thresh is None:
            heavy = np.zeros(a.m, dtype=bool)
        else:
            heavy = lens >= r_thresh
            if not heavy.any() or heavy.all():
                return None
        hmask = heavy[rows]
        nnz_h = int(lens[heavy].sum())
        heavy_best = None
        if nnz_h:
            rows_h = np.nonzero(heavy)[0]
            rp_h = np.concatenate([[0], np.cumsum(lens[heavy])])
            compact = CsrMatrix(len(rows_h), n_ext, rp_h, cols_r[hmask],
                                vals[hmask])
            # fold cost: the scatter-add floor, or — when the fold is
            # large — the binary fold-kernel (F packed as SELL-8W: heavy
            # rows are in natural order, so F is near-diagonal and costs
            # ~1 tile per 128-row slice that contains a heavy row)
            fold_slices = len(np.unique(rows_h >> 7))
            for ml in mega_lens:
                m2, subs = split_megarows(compact, max_len=ml)
                hm = m2 if subs is not None else compact
                th = estimate_sell8w_tiles(hm)
                nfold = hm.m
                fold_cost = min(nfold * p.fold_ns,
                                1.5 * fold_slices * p.row_tile_ns)
                hcost = th * p.row_tile_ns + fold_cost
                if heavy_best is None or hcost < heavy_best[0]:
                    fold = (np.concatenate([rows_h, rows_h[subs]])
                            if subs is not None else rows_h)
                    heavy_best = (hcost, hm, fold, th)
        rp_l = np.zeros(a.m + 1, np.int64)
        rp_l[1:] = np.cumsum(np.where(heavy, 0, lens))
        light = CsrMatrix(a.m, n_ext, rp_l, cols_r[~hmask], vals[~hmask])
        if light.nnz == 0:
            return None
        # the graph tier lives on palette value compression (webbase
        # light tiles are 2 KB meta-only); pick the light bundle width
        # among PALETTE-FEASIBLE candidates first — round-4 regression:
        # the generic chooser under-weights the bf16 stream penalty and
        # picked nw=8 (8-entry palette budget < 24 distinct values),
        # turning every light tile 2 KB → 4 KB
        npal = palette_entry_count(light.vals)
        widths = [w for w in (1, 2, 4, 8)
                  if npal <= (64 >> (w.bit_length() - 1))] or [1, 2, 4, 8]
        best_l = None
        for w in widths:
            tl_w, _c, sp_w = estimate_sell8d_auto(light, nw=w, prices=p)
            tns_w = tile_ns[w] + (
                0.0 if npal <= (64 >> (w.bit_length() - 1)) else p.vals_ns)
            c_w = tl_w * tns_w + sp_w * p.spill_ns
            if best_l is None or c_w < best_l[0]:
                best_l = (c_w, tl_w, sp_w, w)
        _cl, tl, spilled, nw = best_l
        cost = (tl * tile_ns[nw] + spilled * p.spill_ns + k * p.hub_ns
                + (heavy_best[0] if heavy_best else 0.0))
        if heavy_best is not None:
            _h, hm, fold, th = heavy_best
        else:
            hm, fold, th = None, None, 0
        return GraphPrep(
            hub_cols=hub_cols, n_ext=n_ext, heavy=hm,
            fold_rows=fold, light=light, t_heavy=int(th),
            t_light=int(tl), spilled=int(spilled), nw=nw, cost=cost)

    candidates = (*row_thresholds, None)
    if len(candidates) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=min(4, len(candidates))) as ex:
            results = list(ex.map(_evaluate, candidates))
    else:
        results = [_evaluate(c) for c in candidates]
    for cand in results:
        if cand is not None and (best is None or cand.cost < best.cost):
            best = cand
    if best is not None and best.heavy is None and hub_cols is None:
        return None      # degenerate: identical to the plain 8D plan
    return best
