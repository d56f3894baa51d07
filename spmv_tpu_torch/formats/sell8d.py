"""SELL-8D: the deep-slice (slot-per-row) tile format for scattered matrices
(a copy of ``spmv_tpu/formats/sell8d.py`` with ``ml_dtypes`` replaced by
:mod:`._bf16`: bf16 arrays are uint16 bit arrays here; pinned by
``tests/test_torch_formats.py``).

SELL-8W (sell8w.py) assigns rows to LANES (128 rows/slice, depth 8/tile) —
ideal when rows have many nonzeros per 1024-column window.  For scattered
matrices (uniform/power-law) almost every (128-row slice, window) pair is
occupied by a FEW nonzeros, and the pack sits at the pairs lower bound
(measured uniform100k: pad 19.6 = the floor for that layout).

SELL-8D turns the tile 90°: a slice is 1024 ROWS and every tile SLOT is a
row — slot (sublane i, lane l) of a slice's tiles always belongs to row
``1024·slice + 128·i + l``.  Tiles stack in DEPTH per (slice, window) pair:
a row with k nonzeros in a window occupies its fixed slot in k depth tiles.
The kernel accumulates raw per-slot products (``acc += v·xg`` — no
sublane reduction, no row mask), and the (slice, window) pair count drops
8× (1024-row slices), so the pad for uniform scatter falls from the 19.6
floor to the per-row depth distribution (measured uniform100k: 9-11).

Gather-consistency constraint (see sell8w.py docstring): the two-stage
``take_along_axis`` means the meta s-field at slot (i, r) selects the
window SUB-ROW used by every slot of sublane i that references residue r.
In slot-mode the slot position is fixed by the row, so two rows of the same
sublane i referencing the same residue r with different sub-rows s collide
and must sit in different depth tiles — resolved by a vectorized
bump-and-rerank repair loop (measured uniform100k λ=0.41: fully resolved,
zero spill); the rare unresolvable leftovers spill to the XLA straggler
path, as does the deep tail above the adaptive depth cap.

**Window bundles** (``nw`` ∈ {1, 2, 4, 8}): a tile may cover ``nw``
consecutive 1024-column windows — each slot carries a window-select field
(meta bits 10..10+log2(nw)−1) and the kernel gathers from each member
window, selecting per slot.  This divides the (slice, window)-pairs floor
by up to nw for scattered structure at the cost of extra in-tile gathers
(cheap: the v2 kernel is stream/step-bound, not gather-bound) and a
smaller value palette (64 >> log2(nw) entries).

The reference analog is CSR5's tile-transposed layout (avx2/format_avx2.h
aosoa_transpose) combined with Balanced2's row redistribution — re-derived
for the (8,128) tile and the Mosaic gather rules.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np

from ..types import CsrMatrix
from . import _bf16
from .sell8w import (LANES, SUB, WINDOW, df16_encode_lo, df16_safe,
                     value_palette)

__all__ = ["Sell8D", "pack_sell8d", "estimate_sell8d_tiles"]

SLICE_ROWS = WINDOW          # 1024 rows per deep slice = one (8,128) block

def _first_of_group(keys_sorted):
    """Boolean 'starts a new group' mask for a sorted key array."""
    newg = np.empty(len(keys_sorted), dtype=bool)
    newg[0] = True
    np.not_equal(keys_sorted[1:], keys_sorted[:-1], out=newg[1:])
    return newg


def _rank_in_group(keys, return_order: bool = False):
    """Rank of each element within its equal-key group.

    One stable single-key argsort when unsorted (3× faster than lexsort on
    this host, CLAUDE.md); zero sorts when the keys are already sorted (CSR
    with per-row-sorted columns makes row·nwin+window globally sorted).
    With ``return_order`` also returns the sort permutation (None when the
    input was already sorted) so callers can reuse it instead of re-sorting
    — the big sorts are the pack's cost center."""
    n = len(keys)
    base = np.arange(n, dtype=np.int64)
    if np.all(keys[1:] >= keys[:-1]):
        gstart = np.maximum.accumulate(
            np.where(_first_of_group(keys), base, 0))
        rank = base - gstart
        return (rank, None) if return_order else rank
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    gstart = np.maximum.accumulate(np.where(_first_of_group(ks), base, 0))
    rank = np.empty(n, dtype=np.int64)
    rank[order] = base - gstart
    return (rank, order) if return_order else rank


class _SortedMembership:
    """Membership / value lookup against an incrementally grown settled set.

    Kept as a short list of sorted key arrays (one per repair round) —
    lookups are a searchsorted per chunk on the (shrinking) query set,
    avoiding any re-sort of the big round-1 array."""

    def __init__(self):
        self._keys = []
        self._vals = []

    def add(self, keys_sorted: np.ndarray,
            vals: Optional[np.ndarray] = None) -> None:
        if len(keys_sorted):
            self._keys.append(keys_sorted)
            self._vals.append(vals)

    def lookup(self, q: np.ndarray):
        """(found_mask, values) — values only meaningful where found."""
        found = np.zeros(len(q), dtype=bool)
        vals = np.zeros(len(q), dtype=np.int64)
        for keys, kv in zip(self._keys, self._vals):
            pos = np.searchsorted(keys, q)
            ok = pos < len(keys)
            hit = np.zeros(len(q), dtype=bool)
            hit[ok] = keys[pos[ok]] == q[ok]
            if kv is not None:
                vals[hit] = kv[pos[hit]]
            found |= hit
        return found, vals


def _cost_cap(sizes: np.ndarray, dmax_per_pair: np.ndarray,
              nw: int, tile_ns: Optional[float] = None,
              spill_ns: Optional[float] = None) -> int:
    """Depth cap minimizing the measured cost model over candidate caps:

        cost(d) = tiles(d)·TILE_NS  +  tail(d)·SPILL_NS

    with tiles(d) = Σ_pairs min(dmax, d) and tail(d) = Σ_groups
    max(size−d, 0) (the nnz above the cap, spilled to the XLA straggler
    stream).  Both curves come from histograms — O(smax), no per-entry
    work."""
    smax = int(sizes.max())
    cand_max = min(smax, 1024)
    hist_s = np.bincount(np.minimum(sizes, cand_max + 1))
    hist_d = np.bincount(np.minimum(dmax_per_pair, cand_max + 1))
    s_idx = np.arange(len(hist_s), dtype=np.int64)
    d_idx = np.arange(len(hist_d), dtype=np.int64)
    # suffix sums over the histograms; the clipped top bin gets its true
    # mass back so mega-group tails are not under-counted
    cnt_s_ge = np.cumsum(hist_s[::-1])[::-1]          # #groups size ≥ d
    sum_s_ge = np.cumsum((hist_s * s_idx)[::-1])[::-1]
    sum_s_ge += int(np.maximum(sizes - (cand_max + 1), 0).sum())
    cnt_d_ge = np.cumsum(hist_d[::-1])[::-1]
    sum_d_ge = np.cumsum((hist_d * d_idx)[::-1])[::-1]
    sum_d_ge += int(np.maximum(dmax_per_pair - (cand_max + 1), 0).sum())
    d = np.arange(1, cand_max + 1, dtype=np.int64)

    def suffix(arr, i):
        return np.where(i < len(arr), arr[np.minimum(i, len(arr) - 1)], 0)

    tail = suffix(sum_s_ge, d + 1) - d * suffix(cnt_s_ge, d + 1)
    # Σ_p min(dmax, d) = Σ_{v≤d} v·hist + d·#(dmax > d)
    total_d = sum_d_ge[0]
    tiles = (total_d - suffix(sum_d_ge, d + 1)) + d * suffix(cnt_d_ge,
                                                            d + 1)
    cost = tiles * (_TILE_NS[nw] if tile_ns is None else tile_ns) \
        + tail * (_SPILL_NS if spill_ns is None else spill_ns)
    return int(d[np.argmin(cost)])


def _pair_spill_set(pairs_all, dcap_all, kept_all, tile_ns, spill_ns,
                    budget):
    """Pairs worth spilling whole (round 4): their entire KEPT payload
    costs less on the XLA straggler path than their tiles.

    A pair with kept nnz s (= Σ_groups min(size, cap)) and capped depth
    d pays d·tile_ns as tiles or s·spill_ns as stragglers; isolated
    scattered links (the webbase Zipf tail: s = d = 1) pay a whole
    1024-slot tile each without this rule.  Best win first, cumulative
    spill ≤ ``budget`` nnz (the max_spill allowance left after the rank
    tail) so the rule never pushes a previously-valid pack over the
    spill gate.  Returns a SORTED pair-id array or None.
    """
    if budget <= 0:
        return None
    cand = kept_all * spill_ns < dcap_all * tile_ns
    if not cand.any():
        return None
    ci = np.nonzero(cand)[0]
    win = dcap_all[ci] * tile_ns - kept_all[ci] * spill_ns
    order = np.argsort(-win, kind="stable")
    take = np.cumsum(kept_all[ci][order]) <= budget
    sel = ci[order[take]]
    if not len(sel):
        return None
    return np.sort(pairs_all[sel])


def _apply_values(meta, slot_flat, vals_k, lb, ntiles,
                  force_value_mode, palette_values):
    """Fill the value planes for a placed tile stream.

    ``meta`` is the flat uint16 array (slot/cell bits already set); value
    codes are OR'd into bits 10+lb..15.  Returns (value_mode, vals_arr,
    vals_lo, palette, palette_lo).  Shared by the Python and native pack
    paths — placement is value-independent, values are not.
    """
    vals_arr = vals_lo = palette = palette_lo = None
    if np.dtype(vals_k.dtype) == np.float64:
        # double-float: aligned (hi, lo) f32 planes for the EFT kernel —
        # the placement above is value-independent, so one pass builds
        # both (the f64 analog of sell8w's pack-twice trick)
        if force_value_mode not in (None, "df", "df16", "palette_df"):
            raise ValueError(
                f"value mode {force_value_mode!r} incompatible with f64 "
                "input (double-float modes are 'df'/'df16'/'palette_df')")
        if palette_values is not None:
            # shared code table across shards, f64 flavor
            uniq = np.asarray(palette_values, dtype=np.float64)
            if len(uniq) + 1 > (64 >> lb):
                raise ValueError("shared palette exceeds the meta budget")
            nzm = vals_k != 0.0
            pos = np.searchsorted(uniq, vals_k[nzm])
            if (pos >= len(uniq)).any() or not np.array_equal(
                    uniq[np.minimum(pos, len(uniq) - 1)], vals_k[nzm]):
                raise ValueError("values outside the shared palette")
        else:
            uniq = np.unique(vals_k[vals_k != 0.0])
        if force_value_mode == "palette_df" and \
                len(uniq) + 1 > (64 >> lb):
            raise ValueError("palette_df value mode forced but > "
                             f"{64 >> lb} distinct values")
        if (force_value_mode not in ("df", "df16")
                and len(uniq) + 1 <= (64 >> lb)):
            value_mode = "palette_df"
            codes = np.zeros(len(vals_k), dtype=np.int16)
            nzm = vals_k != 0.0
            codes[nzm] = (np.searchsorted(uniq, vals_k[nzm]) + 1) \
                .astype(np.int16)
            palette = np.zeros(LANES, dtype=np.float32)
            palette[1: 1 + len(uniq)] = uniq.astype(np.float32)
            palette_lo = np.zeros(LANES, dtype=np.float32)
            palette_lo[1: 1 + len(uniq)] = (
                uniq - palette[1: 1 + len(uniq)].astype(np.float64)
            ).astype(np.float32)
            code_plane = np.zeros(ntiles * SUB * LANES, dtype=np.uint16)
            code_plane[slot_flat] = (codes.view(np.uint16)
                                     << np.uint16(10 + lb))
            np.bitwise_or(meta, code_plane, out=meta)
            del code_plane
        else:
            # df16 (int16 quantized lo plane, ~40-bit values — 20% less
            # tile stream on the stream-bound df kernels) is the default;
            # full-f32 "df" serves forced requests and values outside the
            # df16 range contract (sell8w.df16_encode_lo)
            use16 = (df16_safe(vals_k) if force_value_mode is None
                     else force_value_mode == "df16")
            if force_value_mode == "df16" and not df16_safe(vals_k):
                raise ValueError("df16 value mode forced but values are "
                                 "outside its normal-range contract")
            value_mode = "df16" if use16 else "df"
            vhi = vals_k.astype(np.float32)
            vlo64 = vals_k - vhi.astype(np.float64)
            vals_arr = np.zeros(ntiles * SUB * LANES, dtype=np.float32)
            vals_arr[slot_flat] = vhi
            vals_arr = vals_arr.reshape(ntiles, SUB, LANES)
            if use16:
                vals_lo = np.zeros(ntiles * SUB * LANES, dtype=np.int16)
                vals_lo[slot_flat] = df16_encode_lo(vhi, vlo64)
            else:
                vals_lo = np.zeros(ntiles * SUB * LANES, dtype=np.float32)
                vals_lo[slot_flat] = vlo64.astype(np.float32)
            vals_lo = vals_lo.reshape(ntiles, SUB, LANES)
    else:
        if palette_values is not None:
            # shared code table (multi-shard packs must decode against ONE
            # palette): codes = position in the given sorted nonzero set
            uniq = np.asarray(palette_values, dtype=np.float32)
            if len(uniq) + 1 > (64 >> lb):
                raise ValueError("shared palette exceeds the meta budget")
            v32 = vals_k.astype(np.float32)
            codes = np.zeros(len(vals_k), dtype=np.int16)
            nzm = v32 != 0.0
            pos = np.searchsorted(uniq, v32[nzm])
            if (pos >= len(uniq)).any() or not np.array_equal(
                    uniq[np.minimum(pos, len(uniq) - 1)], v32[nzm]):
                raise ValueError("values outside the shared palette")
            codes[nzm] = (pos + 1).astype(np.int16)
            palette = np.zeros(LANES, dtype=np.float32)
            palette[1: 1 + len(uniq)] = uniq
            pal = (palette, codes)
        else:
            pal = (value_palette(vals_k, max_entries=64 >> lb)
                   if force_value_mode in (None, "palette") else None)
        if force_value_mode == "palette" and pal is None:
            raise ValueError("palette value mode forced but > "
                             f"{64 >> lb} distinct values")
        if pal is not None:
            palette, codes = pal
            value_mode = "palette"
            code_plane = np.zeros(ntiles * SUB * LANES, dtype=np.uint16)
            code_plane[slot_flat] = (codes.view(np.uint16)
                                     << np.uint16(10 + lb))
            np.bitwise_or(meta, code_plane, out=meta)
            del code_plane
        else:
            v32 = vals_k.astype(np.float32)
            lossless = _bf16.is_lossless(v32)
            if force_value_mode == "bf16" and not lossless:
                raise ValueError("bf16 value mode forced but values are "
                                 "not bf16-exact")
            use_bf16 = (lossless if force_value_mode is None
                        else force_value_mode == "bf16")
            dt = np.uint16 if use_bf16 else np.float32
            value_mode = "bf16" if use_bf16 else "f32"
            vals_arr = np.zeros(ntiles * SUB * LANES, dtype=dt)
            vals_arr[slot_flat] = _bf16.from_f32(v32) if use_bf16 else v32
            vals_arr = vals_arr.reshape(ntiles, SUB, LANES)
    return value_mode, vals_arr, vals_lo, palette, palette_lo


def _choose_g(slice_tiles: np.ndarray, tile_ns: float,
              windowed: bool, keep_empty: bool = True) -> int:
    """Cost-optimal tiles-per-step under the calibrated step/tile model.

    cost(g) = padded_tiles(g)·tile_ns + steps(g)·_STEP_NS, where padding
    rounds each slice's tile run up to a multiple of g (min g).  Few
    tiles per touched slice (web graphs) → padding dominates, pick small
    g; many → the ~75 ns step cost dominates, pick large g
    (probe_webbase_r4e: the old always-g=8 heuristic cost webbase
    0.13 ms/exec).  Windowed-DMA kernels cap at g=16: each step streams
    g separate x-window bundles through VMEM."""
    best_g, best_c = 8, None
    for g in (8, 16) if windowed else (8, 16, 32):
        pad = -(-slice_tiles // g) * g
        if keep_empty:           # untouched slices still cost g zero tiles
            pad = np.maximum(pad, g)
        t = int(pad.sum())
        c = t * tile_ns + (t // g) * _STEP_NS
        if best_c is None or c < best_c:
            best_g, best_c = g, c
    return best_g


def _regroup_slices(tinfo, ginfo, meta_flat, slot_flat, nslices,
                    tile_ns, windowed, keep_empty=True):
    """Re-pad a g=1 (ungrouped) native pack to the cost-optimal g.

    The native packer's tile layout is g-independent (g only inserts
    per-slice zero pad tiles and groups steps), so ``g="auto"`` packs at
    g=1 — ginfo is then one entry per tile, ``slice << 1 | first`` —
    and this pass chooses g from the real per-slice tile counts and
    rebuilds tinfo/ginfo/meta/slot positions at the padded layout.

    ``keep_empty=False`` gives untouched slices ZERO tiles instead of the
    g-tile minimum — only valid when the consumer compacts the output to
    visited slices (the striped executor's scatter-add; round-4 advisor:
    with the minimum pad the striped "touched-slice compaction" was a
    no-op and every stripe paid g zero tiles per untouched slice)."""
    nt = len(tinfo)
    cell = SUB * LANES
    slice_of_tile = (ginfo >> 1).astype(np.int64)
    if not keep_empty:
        # the native g=1 pack gives every EMPTY slice one pure-pad tile
        # (kernel zero-init rule); drop those tiles — a slice is occupied
        # iff some kept entry's slot lands in it, and at g=1 occupied
        # slices carry no pad tiles at all
        occupied = np.zeros(nslices, dtype=bool)
        occupied[slice_of_tile[np.unique(slot_flat // cell)]] = True
        if not occupied.all():
            tile_keep = occupied[slice_of_tile]
            new_of_old = np.cumsum(tile_keep) - 1
            old_t = slot_flat // cell
            slot_flat = slot_flat + (new_of_old[old_t] - old_t) * cell
            tinfo = tinfo[tile_keep]
            meta_flat = (meta_flat.reshape(nt, cell)[tile_keep]
                         .reshape(-1))
            ginfo = ginfo[tile_keep]
            slice_of_tile = slice_of_tile[tile_keep]
            nt = len(tinfo)
    counts = np.bincount(slice_of_tile, minlength=nslices)
    g = _choose_g(counts, tile_ns, windowed, keep_empty)
    padded = -(-counts // g) * g
    if keep_empty:   # every output block visited once → zero-initialized
        padded = np.maximum(padded, g)
    base = np.concatenate([[0], np.cumsum(padded)[:-1]])
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    newt = (base[slice_of_tile]
            + np.arange(nt, dtype=np.int64) - starts[slice_of_tile])
    nt2 = int(padded.sum())
    tinfo2 = np.zeros(nt2, dtype=np.int32)
    tinfo2[newt] = tinfo
    mf = meta_flat.reshape(nt, SUB * LANES)
    meta2 = np.zeros((nt2, SUB * LANES), dtype=meta_flat.dtype)
    meta2[newt] = mf
    cell = SUB * LANES
    old_t = slot_flat // cell
    slot2 = slot_flat + (newt[old_t] - old_t) * cell
    nsteps = nt2 // g
    sg = np.repeat(np.arange(nslices, dtype=np.int64), padded // g)
    first = np.ones(nsteps, dtype=np.int64)
    first[1:] = (sg[1:] != sg[:-1]).astype(np.int64)
    ginfo2 = (sg << 1 | first).astype(np.int32)
    return tinfo2, ginfo2, meta2.reshape(-1), slot2, g


def pack_sell8d(a: CsrMatrix, g: Union[int, str] = 16,
                max_pad_ratio: float = 10.0,
                depth_cap: Union[int, str, None] = "auto",
                max_repair: int = 8, max_spill: float = 0.02,
                nw: int = 1, force_value_mode: Optional[str] = None,
                palette_values: Optional[np.ndarray] = None,
                use_native: bool = True,
                keep_empty_slices: bool = True,
                cell_w: bool = False
                ) -> Tuple["Sell8D", Optional[tuple]]:
    """Pack into the slot-mode deep-slice stream.

    Returns ``(packed, rest)`` where ``rest`` is ``None`` or a
    ``(rows, cols, vals)`` COO remainder — the rank tail above the depth
    cap plus s-table conflicts that survived the repair loop — for the XLA
    straggler path.  Raises ValueError when the pad gate or the spill gate
    fails.

    ``depth_cap``: "auto" picks the cap minimizing the calibrated cost
    model (:func:`_cost_cap`: budget tiles vs straggler tail — the deep
    tail is what drives the pad: one row with k nonzeros in a window forces k
    full tiles on its pair); an int pins it; None disables capping.
    ``max_spill`` gates the realized total spill fraction.

    ``nw``: windows per bundle tile (1, 2, 4 or 8 — see module docstring).
    ``g="auto"`` picks the tiles-per-step grouping from the calibrated
    step/tile cost model (:func:`_choose_g`) after the layout is known.

    ``cell_w=True`` (nw > 1 only) stores the window-select in the shared
    CELL table (i, r) alongside s instead of per slot — entries sharing a
    cell must then agree on (s, w), ~12.5% more conflicts — which lets
    the kernel merge the nw take0 gathers BEFORE one final take1:
    2·nw+1 vector ops per plane instead of 3·nw (the round-5 op-count
    lever after the wide-gather fusion was ruled out,
    baselines/probe_wide_gather_r5.out).  Python pack path only.

    ``keep_empty_slices=False`` drops untouched slices from the tile
    stream entirely (zero tiles instead of the g minimum) — ONLY for
    consumers that compact output blocks to visited slices, i.e. the
    striped executor (the v2 kernels zero an output block on first visit;
    a never-visited block holds garbage unless the consumer drops it).
    """
    if a.nnz == 0:
        raise ValueError("empty matrix has no SELL-8D packing")
    g_auto = g == "auto"
    if not g_auto:
        g = int(g)
    nw = int(nw)                 # numpy ints lack .bit_length()
    if nw not in (1, 2, 4, 8):
        raise ValueError(f"nw must be 1, 2, 4 or 8, got {nw}")
    lb = nw.bit_length() - 1
    m, n = a.m, a.n
    nwin = max(-(-n // (WINDOW * nw)), 1)      # bundles of nw windows
    nslices = max(-(-m // SLICE_ROWS), 1)
    if nslices * nwin > (1 << 50):
        # int64 cell-key space: (pair·md)·WINDOW must not overflow
        raise ValueError(
            f"SELL-8D pair space {nslices}x{nwin} overflows the packer's "
            "key space; use the XLA plans")

    # native fast path: the sequential greedy packer (native/spmv_native
    # .cpp sell8d_pack) resolves the same slot/s-cell constraints in one
    # C++ pass (~10x the numpy pipeline on this host); 'auto'/int caps
    # only — the uncapped case stays in Python (tests use it).  The native
    # packer allocates a DENSE (slice, bundle) table — skip it when that
    # table would exceed ~2 GB (huge m·n; the numpy path is sparse).
    df_in = np.dtype(a.dtype) == np.dtype(np.float64)
    tns_tab, spill_ns = cost_tables(n > _V2_MAX_N, df_in)
    if use_native and nslices * nwin <= (1 << 28) \
            and (keep_empty_slices or g_auto) \
            and (depth_cap == "auto"
                 or (isinstance(depth_cap, int) and depth_cap > 0)):
        from ..native import pack_sell8d_native
        nat = pack_sell8d_native(
            m, n, a.rowptr, a.colidx, nw=nw, g=1 if g_auto else g,
            depth_cap=-1 if depth_cap == "auto" else int(depth_cap),
            tile_ns=tns_tab[nw], spill_ns=spill_ns,
            pair_spill_ns=(_PAIR_SPILL_NS_DF if df_in
                           else _PAIR_SPILL_NS),
            max_spill=max_spill, cell_w=bool(cell_w and nw > 1))
        if nat is not None:
            (tinfo, ginfo, meta_flat, slot_flat, kept_idx, spill_idx,
             _cap) = nat
            if g_auto:
                tinfo, ginfo, meta_flat, slot_flat, g = _regroup_slices(
                    tinfo, ginfo, meta_flat, slot_flat, nslices,
                    tns_tab[nw], n > _V2_MAX_N, keep_empty_slices)
            ntiles = len(tinfo)
            nnz_kept = len(kept_idx)
            if nnz_kept == 0:
                raise ValueError("sell8d pack kept no nonzeros")
            frac = len(spill_idx) / a.nnz
            if frac > max_spill:
                raise ValueError(f"sell8d spill fraction {frac:.3f} "
                                 f"exceeds {max_spill}")
            pad_ratio = ntiles * WINDOW / nnz_kept
            if pad_ratio > max_pad_ratio:
                raise ValueError(f"sell8d pad ratio {pad_ratio:.1f} "
                                 f"exceeds {max_pad_ratio}")
            vals_k = np.asarray(a.vals)[kept_idx]
            meta_u16 = meta_flat.view(np.uint16)
            (value_mode, vals_arr, vals_lo, palette,
             palette_lo) = _apply_values(meta_u16, slot_flat, vals_k, lb,
                                         ntiles, force_value_mode,
                                         palette_values)
            packed = Sell8D(
                m=m, n=n, nnz_stored=nnz_kept, nslices=nslices, g=g,
                ntiles=ntiles, nsteps=ntiles // g, value_mode=value_mode,
                tinfo=tinfo, ginfo=ginfo,
                meta=meta_u16.view(np.int16).reshape(ntiles, SUB, LANES),
                vals=vals_arr, palette=palette, nw=nw,
                vals_lo=vals_lo, palette_lo=palette_lo,
                cell_w=bool(cell_w and nw > 1))
            rest = None
            if len(spill_idx):
                sp_rows = (np.searchsorted(
                    a.rowptr.astype(np.int64), spill_idx,
                    side="right") - 1).astype(np.int64)
                rest = (sp_rows, np.asarray(a.colidx)[spill_idx],
                        np.asarray(a.vals)[spill_idx])
            return packed, rest

    lens = a.row_lengths.astype(np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64), lens)
    cols = a.colidx.astype(np.int64)
    rw = rows * nwin + (cols >> (10 + lb))

    rank, rw_order = _rank_in_group(rw, return_order=True)
    # full-set (row, bundle) group sizes and their pair ids — the cap's
    # cost scan needs the per-pair depth maxima; reuse the rank pass's
    # sort permutation rather than re-sorting 4M keys
    rws = rw if rw_order is None else rw[rw_order]
    fstarts = np.nonzero(_first_of_group(rws))[0]
    fsizes = np.diff(np.concatenate([fstarts, [len(rw)]]))
    rw_u = rws[fstarts]
    pairg = ((rw_u // nwin) >> 10) * nwin + rw_u % nwin
    po = np.argsort(pairg, kind="stable")
    pgs = pairg[po]
    pstarts_f = np.nonzero(_first_of_group(pgs))[0]
    pairs_all = pgs[pstarts_f]
    dmax_all = np.maximum.reduceat(fsizes[po], pstarts_f)

    if depth_cap == "auto":
        cap = _cost_cap(fsizes, dmax_all, nw, tile_ns=tns_tab[nw],
                        spill_ns=spill_ns)
    elif depth_cap is None:
        cap = int(rank.max()) + 1
    else:
        cap = int(depth_cap)

    # Pair-level spill (round 4): a pair whose whole kept payload costs
    # less on the XLA straggler path than its tiles drops entirely — an
    # isolated scattered link otherwise pays a whole 1024-slot tile for
    # 1-3 nonzeros (the webbase Zipf-tail pad source).  See
    # _pair_spill_set for the budgeting.
    capped_f = np.minimum(fsizes, cap)
    kept_all = np.add.reduceat(capped_f[po], pstarts_f)
    drop_pairs = _pair_spill_set(pairs_all, np.minimum(dmax_all, cap),
                                 kept_all, tns_tab[nw],
                                 _PAIR_SPILL_NS_DF if df_in
                                 else _PAIR_SPILL_NS,
                                 int(max_spill * len(rows))
                                 - int((fsizes - capped_f).sum()))

    keep0 = rank < cap
    if drop_pairs is not None:
        pair_e = (rows >> 10) * nwin + (cols >> (10 + lb))
        pos = np.searchsorted(drop_pairs, pair_e)
        keep0 &= ~((pos < len(drop_pairs))
                   & (drop_pairs[np.minimum(pos, len(drop_pairs) - 1)]
                      == pair_e))
    idx = np.nonzero(keep0)[0]
    krw, krank = rw[idx], rank[idx]
    krow, kcol = rows[idx], cols[idx]
    nk = len(idx)
    if nk == 0:
        raise ValueError("sell8d pack kept no nonzeros")
    # derive tile coordinates on the kept set only (one gather each for
    # rows/cols, cheap arithmetic after — 4M-element fancy gathers are the
    # pack's cost center on this host)
    cin = kcol & 1023
    ks = cin >> 7
    kr = cin & 127
    kw = (kcol >> 10) & (nw - 1)        # window-select within the bundle
    # cell agreement value: classic layout shares s per (i, r) cell;
    # cell_w shares (s, w) jointly (see pack_sell8d docstring)
    kcv = ks if (not cell_w or lb == 0) else (ks | (kw << 3))
    r_in = krow & (SLICE_ROWS - 1)
    ki = r_in >> 7
    l_lane = r_in & 127
    kpair = (krow >> 10) * nwin + (kcol >> (10 + lb))

    # Per-pair depth budget = min(dmax, cap).  Initial depths spread each
    # row's entries across the budget ((rank + row) mod budget — balancing
    # cell occupancy cuts the round-1 s-conflict rate ~2×, measured 11% →
    # 5.6% on uniform100k), and repair bumps WRAP within the budget;
    # whatever a full cycle cannot place gets fresh OVERFLOW depth levels
    # afterwards (a spilled nonzero costs ~15 ns on the XLA gather floor
    # vs ~30 ns for a whole overflow tile that absorbs many — measured
    # uniform100k: 51k conflict-spills cost 0.79 ms, 4× the kernel).
    kdmax = np.minimum(dmax_all[np.searchsorted(pairs_all, kpair)], cap)
    # stride covers the budget plus the overflow levels (≤ cap + bumps)
    md = 2 * cap + max_repair + 8
    # the static nslices·nwin ≤ 2^50 gate above cannot see md; re-check
    # the exact bound now that md is known: cell_key's
    # (pair·md + depth)·WINDOW + slot must stay inside int64 (ADVICE
    # round-3 — reachable only at astronomically large m·n·cap)
    if nslices * nwin > (1 << 62) // (md * WINDOW):
        raise ValueError(
            f"SELL-8D cell-key space {nslices}x{nwin}x{md} overflows "
            "int64; use the XLA plans")
    depth = (krank + krow) % kdmax

    def cell_key(p, d, i, r):
        return (p * md + d) * WINDOW + i * LANES + r

    # round 1 (full set): depths are distinct per (row, window) group by
    # construction; only the shared s-table can collide
    cell = cell_key(kpair, depth, ki, kr)
    o = np.argsort(cell, kind="stable")
    cs = cell[o]
    pos = np.arange(nk, dtype=np.int64)
    winner = np.maximum.accumulate(np.where(_first_of_group(cs), pos, 0))
    conflict = np.zeros(nk, dtype=bool)
    conflict[o] = kcv[o] != kcv[o[winner]]

    slots = _SortedMembership()
    cells = _SortedMembership()
    ok = ~conflict
    slot_keys = krw * md + depth       # unique per kept entry
    sk = slot_keys[ok]
    slots.add(sk if np.all(sk[1:] >= sk[:-1]) else np.sort(sk))
    mask_sorted = ok[o]
    cells.add(cs[mask_sorted], kcv[o][mask_sorted])

    sub = np.nonzero(conflict)[0]
    # exactly max_repair wrap rounds — whatever is left goes to the
    # overflow levels, so a small cap only trades a few extra tiles
    rounds = max_repair
    for _ in range(rounds):
        if not len(sub):
            break
        depth[sub] = (depth[sub] + 1) % kdmax[sub]
        k1 = krw[sub] * md + depth[sub]
        dup, _ = slots.lookup(k1)
        o1 = np.argsort(k1, kind="stable")
        d_in = np.zeros(len(sub), dtype=bool)
        d_in[o1] = ~_first_of_group(k1[o1])
        dup |= d_in
        cq = cell_key(kpair[sub], depth[sub], ki[sub], kr[sub])
        found, wsv = cells.lookup(cq)
        o2 = np.argsort(cq, kind="stable")
        cqs = cq[o2]
        p2 = np.arange(len(sub), dtype=np.int64)
        win2 = np.maximum.accumulate(np.where(_first_of_group(cqs), p2, 0))
        ss = kcv[sub]
        sc_in = np.zeros(len(sub), dtype=bool)
        sc_in[o2] = ss[o2] != ss[o2[win2]]
        sconf = np.where(found, wsv != ss, sc_in)
        conf = dup | sconf
        slots.add(np.sort(k1[~conf]))
        oksort = (~conf)[o2]
        cells.add(cqs[oksort], ss[o2][oksort])
        sub = sub[conf]

    # overflow phase: whatever the wrap cycle could not place opens FRESH
    # depth levels above the pair budget (an overflow tile absorbs up to
    # 1024 leftovers at tile cost; the XLA straggler path costs ~15 ns per
    # nonzero).  Fresh levels cannot collide with settled entries (every
    # prior cell/slot key has depth < budget), only among themselves —
    # ranks are distinct per (row, bundle) group, so only the s-table can
    # conflict, resolved by plain upward bumps.
    still = np.zeros(nk, dtype=bool)
    if len(sub):
        osort = np.argsort(krw[sub], kind="stable")
        ov_rank = _rank_in_group(krw[sub][osort])   # sorted → zero-sort path
        od = np.empty(len(sub), dtype=np.int64)
        od[osort] = ov_rank
        depth[sub] = kdmax[sub] + od
        cells2 = _SortedMembership()
        slots2 = _SortedMembership()
        osub = sub
        for _ in range(3):
            if not len(osub):
                break
            k1 = krw[osub] * md + depth[osub]
            dup, _ = slots2.lookup(k1)
            o1 = np.argsort(k1, kind="stable")
            d_in = np.zeros(len(osub), dtype=bool)
            d_in[o1] = ~_first_of_group(k1[o1])
            dup |= d_in
            cq = cell_key(kpair[osub], depth[osub], ki[osub], kr[osub])
            found, wsv = cells2.lookup(cq)
            o2 = np.argsort(cq, kind="stable")
            cqs = cq[o2]
            p2 = np.arange(len(osub), dtype=np.int64)
            win2 = np.maximum.accumulate(
                np.where(_first_of_group(cqs), p2, 0))
            ss = kcv[osub]
            sc_in = np.zeros(len(osub), dtype=bool)
            sc_in[o2] = ss[o2] != ss[o2[win2]]
            conf = dup | np.where(found, wsv != ss, sc_in)
            slots2.add(np.sort(k1[~conf]))
            oksort = (~conf)[o2]
            cells2.add(cqs[oksort], ss[o2][oksort])
            osub = osub[conf]
            depth[osub] += 1
        still[osub] = True

    spill = ~keep0
    spill[idx[still]] = True
    frac = float(spill.sum()) / len(rows)
    if frac > max_spill:
        raise ValueError(
            f"sell8d spill fraction {frac:.3f} exceeds {max_spill}")
    fin = ~still
    depth_k, pair_k = depth[fin], kpair[fin]
    i_k, l_k = ki[fin], l_lane[fin]
    s_k, r_k, w_k = ks[fin], kr[fin], kw[fin]
    vals_k = np.asarray(a.vals)[idx[fin]]
    nnz_kept = len(vals_k)
    if nnz_kept == 0:
        raise ValueError("sell8d pack kept no nonzeros")

    # realized per-pair tile counts (max kept depth + 1) — pairs that lost
    # every entry drop out; overflow levels extend their pair's run
    po2 = np.argsort(pair_k, kind="stable")
    ps2 = pair_k[po2]
    pstarts2 = np.nonzero(_first_of_group(ps2))[0]
    pairs_unique = ps2[pstarts2]
    tiles_per_pair = np.maximum.reduceat(depth_k[po2], pstarts2) + 1

    # per-slice padding to a multiple of g (min g — every output block
    # must be touched at least once to get zero-initialized)
    tiles_per_pair = tiles_per_pair.astype(np.int64)
    slice_of_pair = pairs_unique // nwin
    slice_tiles = np.zeros(nslices, dtype=np.int64)
    np.add.at(slice_tiles, slice_of_pair, tiles_per_pair)
    if g_auto:
        g = _choose_g(slice_tiles, tns_tab[nw], n > _V2_MAX_N,
                      keep_empty_slices)
    slice_padded = -(-slice_tiles // g) * g
    if keep_empty_slices:   # untouched output blocks must be visited once
        slice_padded = np.maximum(slice_padded, g)
    ntiles = int(slice_padded.sum())
    pad_ratio = ntiles * WINDOW / nnz_kept
    if pad_ratio > max_pad_ratio:
        raise ValueError(
            f"sell8d pad ratio {pad_ratio:.1f} exceeds {max_pad_ratio}")

    slice_base = np.concatenate([[0], np.cumsum(slice_padded)[:-1]])
    # within-slice running offset per pair (pairs are slice-major sorted)
    run = np.concatenate([[0], np.cumsum(tiles_per_pair)[:-1]])
    slice_first = np.concatenate(
        [[True], slice_of_pair[1:] != slice_of_pair[:-1]])
    slice_run0 = np.maximum.accumulate(np.where(slice_first, run, 0))
    pair_base = slice_base[slice_of_pair] + (run - slice_run0)

    tile = pair_base[np.searchsorted(pairs_unique, pair_k)] + depth_k

    # meta: slot fields (residue bits 0-6, window-select bits 10..10+lb−1,
    # value code bits 10+lb..15) live at (tile, i, l) — unique per entry,
    # plain fancy assignment; the shared s-table field (bits 7-9) lives at
    # (tile, i, r) — entries sharing a cell agree on s by construction, so
    # duplicate writes are idempotent.  Two planes OR-merged once
    # (bitwise_or.at measured ~20 s at 4M nnz).
    slot_flat = (tile * SUB + i_k) * LANES + l_k
    cell_flat = (tile * SUB + i_k) * LANES + r_k
    meta = np.zeros(ntiles * SUB * LANES, dtype=np.uint16)
    slot_bits = r_k.astype(np.uint16)
    if lb and not cell_w:
        slot_bits |= w_k.astype(np.uint16) << np.uint16(10)
    meta[slot_flat] = slot_bits
    s_plane = np.zeros(ntiles * SUB * LANES, dtype=np.uint16)
    cell_bits = s_k.astype(np.uint16) << np.uint16(7)
    if lb and cell_w:
        # window-select rides the CELL table (entries sharing (i, r)
        # agree on (s, w) by construction — duplicate writes idempotent)
        cell_bits |= w_k.astype(np.uint16) << np.uint16(10)
    s_plane[cell_flat] = cell_bits
    np.bitwise_or(meta, s_plane, out=meta)
    del s_plane

    value_mode, vals_arr, vals_lo, palette, palette_lo = _apply_values(
        meta, slot_flat, vals_k, lb, ntiles, force_value_mode,
        palette_values)
    meta = meta.reshape(ntiles, SUB, LANES)

    tinfo = np.zeros(ntiles, dtype=np.int32)
    # expand (pair → its tile range) to set the window id on every real tile
    w_of_pair = (pairs_unique % nwin).astype(np.int64)
    total_real = int(tiles_per_pair.sum())
    intra = (np.arange(total_real, dtype=np.int64)
             - np.repeat(run, tiles_per_pair))
    tile_ids = np.repeat(pair_base, tiles_per_pair) + intra
    tinfo[tile_ids] = (np.repeat(w_of_pair, tiles_per_pair) << 3) \
        .astype(np.int32)

    nsteps = ntiles // g
    step_slice = np.repeat(np.arange(nslices, dtype=np.int64),
                           slice_padded // g)
    first = np.ones(nsteps, dtype=np.int64)
    first[1:] = (step_slice[1:] != step_slice[:-1]).astype(np.int64)
    ginfo = (step_slice << 1 | first).astype(np.int32)

    packed = Sell8D(
        m=m, n=n, nnz_stored=nnz_kept, nslices=nslices, g=g,
        ntiles=ntiles, nsteps=nsteps, value_mode=value_mode,
        tinfo=tinfo, ginfo=ginfo, meta=meta.view(np.int16),
        vals=vals_arr, palette=palette, nw=nw,
        vals_lo=vals_lo, palette_lo=palette_lo,
        cell_w=bool(cell_w and lb))
    rest = None
    if spill.any():
        rest = (rows[spill], cols[spill], np.asarray(a.vals)[spill])
    return packed, rest


#: column-striped resident mode (round 4).  Past the VMEM-x envelope the
#: windowed kernels pay an nw·4 KB x-window DMA PER TILE (_TILE_NS_W:
#: 236 ns/tile at nw=8 vs 29 resident — 8x) while a column stripe of
#: ≤ _V2_MAX_N keeps its x slice VMEM-resident and pays the slice load
#: ONCE per pallas_call.  Stripe widths are multiples of WINDOW·8 = 8192
#: so stripe-local bundle grids align with the global grid for every
#: nw ∈ {1,2,4,8} — per-stripe tile counts sum to the whole-matrix
#: estimate (no bundle straddles a boundary).
STRIPE_ALIGN = WINDOW * 8
#: per-exec stripe budget: past this the per-call overhead dominates and
#: the windowed kernels take back over (n > ~128M)
MAX_STRIPES = 64
#: spill allowance for the striped/windowed scattered regime: wide (nw=8)
#: bundles at uniform scatter spill same-row-same-bundle collisions
#: (measured 3.2% on uniform d=32 over n=4M — each row expects ~1 repeat
#: among 489 bundles); housing them as depth-2 tiles DOUBLES the stream
#: (48k → 98k tiles measured) while the compact rest path costs
#: ~2-28 ns/nnz.  The cost model prices both — this gate only guards
#: against rest-stream blowups, so it sits above the collision regime.
MAX_SPILL_STRIPED = 0.05


def column_stripe_bounds(n: int):
    """Bundle-aligned column stripe bounds covering [0, n) with every
    stripe width ≤ _V2_MAX_N (x slice VMEM-resident)."""
    if n <= _V2_MAX_N:
        return [(0, n)]
    max_w = (_V2_MAX_N // STRIPE_ALIGN) * STRIPE_ALIGN
    nstripes = -(-n // max_w)
    per = -(-n // nstripes)
    width = -(-per // STRIPE_ALIGN) * STRIPE_ALIGN
    return [(lo, min(lo + width, n)) for lo in range(0, n, width)]


def stripe_overhead_ns(n: int) -> float:
    """Per-exec overhead of the striped plan: one pallas_call plus one
    x-slice VMEM load per stripe (~0.027 ns/B at the ~150 GB/s stream
    rate the tile tables are calibrated against)."""
    nstripes = len(column_stripe_bounds(n))
    return nstripes * _STRIPE_CALL_NS + n * 4 * 0.027


def pack_sell8d_striped(a: CsrMatrix, max_pad_ratio: float = 10.0,
                        nw: int = 1,
                        max_spill: float = MAX_SPILL_STRIPED,
                        force_value_mode: Optional[str] = None,
                        use_native: bool = True, cell_w: bool = False):
    """Column-striped resident slot-mode pack for n > _V2_MAX_N.

    Slices the matrix into bundle-aligned column stripes, packs each as
    an independent :class:`Sell8D` (columns rebased to the stripe), and
    compacts every stripe's output-block space to its TOUCHED slices —
    the v2 kernels zero an output block only on first visit, so a
    stripe-empty slice must not appear in the grid at all.  The executor
    runs the resident slot kernel per stripe on ``x[lo:hi]`` and
    scatter-adds the compact blocks (handle._make_bound).

    Returns ``(stripes, rest, pad_ratio)`` where ``stripes`` is a list of
    ``(lo, hi, vis_slices, packed)`` and ``rest`` is the merged COO
    remainder with GLOBAL column ids.  Pad/spill gates apply to the
    whole-matrix totals — a skewed stripe must not kill a globally fine
    plan — so the per-stripe packs run ungated.
    """
    bounds = column_stripe_bounds(a.n)
    if len(bounds) == 1:
        raise ValueError("striping needs n past the VMEM-x envelope")
    if len(bounds) > MAX_STRIPES:
        raise ValueError(f"{len(bounds)} stripes exceed MAX_STRIPES")
    lens = a.row_lengths.astype(np.int64)
    rows_all = np.repeat(np.arange(a.m, dtype=np.int64), lens)
    colidx = np.asarray(a.colidx)
    vals = np.asarray(a.vals)
    subs = []
    for lo, hi in bounds:
        keep = (colidx >= lo) & (colidx < hi)
        if not keep.any():
            continue
        rows_s = rows_all[keep]
        rp = np.zeros(a.m + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows_s, minlength=a.m), out=rp[1:])
        subs.append((lo, hi, CsrMatrix(
            a.m, hi - lo, rp, (colidx[keep] - lo).astype(colidx.dtype),
            vals[keep])))

    def _pack_all(depth_cap):
        stripes, rest_parts = [], []
        tot_tiles = tot_kept = tot_spill = 0
        for lo, hi, sub in subs:
            packed, rest = pack_sell8d(
                sub, g="auto", max_pad_ratio=float("inf"), max_spill=1.0,
                depth_cap=depth_cap, nw=nw,
                force_value_mode=force_value_mode, use_native=use_native,
                keep_empty_slices=False, cell_w=cell_w)
            gi = np.asarray(packed.ginfo)
            sl = gi >> 1
            vis = np.unique(sl)      # ginfo is output-block monotone
            gi2 = ((np.searchsorted(vis, sl) << 1)
                   | (gi & 1)).astype(np.int32)
            packed = dataclasses.replace(
                packed, m=len(vis) * SLICE_ROWS, nslices=len(vis),
                ginfo=gi2)
            stripes.append((lo, hi, vis.astype(np.int64), packed))
            tot_tiles += packed.ntiles
            tot_kept += packed.nnz_stored
            if rest is not None:
                rest_parts.append((rest[0],
                                   rest[1].astype(np.int64) + lo,
                                   rest[2]))
                tot_spill += len(rest[0])
        return stripes, rest_parts, tot_tiles, tot_kept, tot_spill

    # Pre-estimate the auto-cap pad BEFORE the (expensive, per-stripe)
    # packs: at 32M nnz the doomed auto-cap pass costs ~50 s of native
    # pack + value-plane fills only to be retried at cap=1 (round-5
    # sweep: the scattered4m predeal outlier).  The stats run on the
    # whole matrix with the resident tables; realized striped pad runs
    # up to ~2x the estimate on uniform scatter (PERFNOTES), so only a
    # CLEARLY hopeless estimate (> 1.5x budget) skips straight to the
    # shallow cap — the existing retry remains the safety net.
    start_cap = "auto"
    t_est, _c_est, sp_est = estimate_sell8d_auto(
        a, nw=int(nw), windowed=False, max_spill=max_spill)
    if t_est and t_est * WINDOW / max(a.nnz - sp_est, 1) \
            > 1.5 * max_pad_ratio:
        start_cap = 1
    stripes, rest_parts, tot_tiles, tot_kept, tot_spill = \
        _pack_all(start_cap)
    if (start_cap == "auto" and tot_kept
            and tot_tiles * WINDOW / tot_kept > max_pad_ratio
            and any(s[3].ntiles for s in stripes)):
        # the auto cap chooser decides on tile-vs-spill ECONOMICS alone
        # (a near-tie at 28-vs-29 ns goes deep, measured cap=2 pad 33 vs
        # cap=1 pad 15.5 on uniform d=32 n=4M) — the pad/HBM budget is
        # enforced here, so retry shallow before giving up
        s1 = _pack_all(1)
        if s1[3] and s1[2] * WINDOW / s1[3] < tot_tiles * WINDOW \
                / tot_kept and s1[4] <= max_spill * a.nnz:
            stripes, rest_parts, tot_tiles, tot_kept, tot_spill = s1
    if not tot_kept:
        raise ValueError("striped sell8d pack kept no nonzeros")
    if tot_spill > max_spill * a.nnz:
        raise ValueError(f"striped spill fraction {tot_spill/a.nnz:.3f} "
                         f"exceeds {max_spill}")
    pad = tot_tiles * WINDOW / tot_kept
    if pad > max_pad_ratio:
        raise ValueError(f"striped pad ratio {pad:.1f} exceeds "
                         f"{max_pad_ratio}")
    rest = None
    if rest_parts:
        rest = tuple(np.concatenate([p[i] for p in rest_parts])
                     for i in range(3))
    return stripes, rest, pad


@dataclasses.dataclass(frozen=True)
class Sell8D:
    """Grouped slot-mode tile stream for the v2 kernel's slot_mode path."""

    m: int
    n: int
    nnz_stored: int
    nslices: int               # ceil(m / 1024)
    g: int                     # tiles per grid step
    ntiles: int                # padded to G per slice
    nsteps: int
    # "palette" | "bf16" | "f32" | "df" | "df16" | "palette_df"
    value_mode: str
    tinfo: np.ndarray          # (ntiles,) int32: bundle << 3
    ginfo: np.ndarray          # (nsteps,) int32: slice << 1 | first_flag
    meta: np.ndarray           # (ntiles, 8, 128) int16:
    #   s<<7 | r  (cell/slot planes) | wsel<<10 | code<<(10+log2 nw)
    vals: Optional[np.ndarray]   # (ntiles, 8, 128), None for palette
    palette: Optional[np.ndarray]  # (128,) f32
    nw: int = 1                # windows per bundle tile
    #: double-float (f64) low parts — aligned with vals/palette
    vals_lo: Optional[np.ndarray] = None
    palette_lo: Optional[np.ndarray] = None
    #: window-select lives in the shared cell table (see pack_sell8d)
    cell_w: bool = False

    @property
    def pad_ratio(self) -> float:
        return self.ntiles * WINDOW / max(self.nnz_stored, 1)


def _bundle_group_stats(a: CsrMatrix, lb: int, rows=None):
    """(group sizes, pair id per group) at bundle granularity 2**lb
    windows.  One pass over nnz; groups are (row, bundle)."""
    nwin = max(-(-a.n // (WINDOW << lb)), 1)
    if rows is None:
        lens = a.row_lengths.astype(np.int64)
        rows = np.repeat(np.arange(a.m, dtype=np.int64), lens)
    rw = rows * nwin + (a.colidx.astype(np.int64) >> (10 + lb))
    if not np.all(rw[1:] >= rw[:-1]):
        rw = np.sort(rw)
    starts = np.nonzero(_first_of_group(rw))[0]
    sizes = np.diff(np.concatenate([starts, [len(rw)]]))
    rw_u = rw[starts]
    pw = ((rw_u // nwin) >> 10) * nwin + rw_u % nwin
    return sizes, pw


def split_by_window_density(a: CsrMatrix, thresh: int = 4):
    """Partition nnz by (row, window) group size: groups with ≥ ``thresh``
    nonzeros form the DENSE part (the SELL-8W row-mode regime — a row-
    window segment that fills tile depth), the rest the SPARSE part (the
    SELL-8D bundle regime).  Returns ``(dense, sparse, dense_frac)`` with
    either matrix ``None`` when empty.

    NOTE: the production planner uses :func:`prepare_hybrid`'s ROW-length
    split instead — a heavy row's scattered singles poison the slot-mode
    layout when left behind (measured powerlaw100k: 15.5k vs 3.6k sparse
    tiles).  This finer window-granular split is kept as a public analysis
    tool (the reference analog is Balanced2's mega-row redistribution,
    parallel_balanced2_spmv.c:55-209, at window granularity).
    """
    if a.nnz == 0:
        return None, None, 0.0
    nwin = max(-(-a.n // WINDOW), 1)
    lens = a.row_lengths.astype(np.int64)
    rows = np.repeat(np.arange(a.m, dtype=np.int64), lens)
    rw = rows * nwin + (a.colidx.astype(np.int64) >> 10)
    if np.all(rw[1:] >= rw[:-1]):
        starts = np.nonzero(_first_of_group(rw))[0]
        sizes = np.diff(np.concatenate([starts, [len(rw)]]))
        gsz = np.repeat(sizes, sizes)
    else:
        o = np.argsort(rw, kind="stable")
        starts = np.nonzero(_first_of_group(rw[o]))[0]
        sizes = np.diff(np.concatenate([starts, [len(rw)]]))
        gsz = np.empty(len(rw), dtype=np.int64)
        gsz[o] = np.repeat(sizes, sizes)
    dense = gsz >= thresh
    frac = float(dense.mean())

    def sub(mask):
        if not mask.any():
            return None
        r = rows[mask]
        rp = np.zeros(a.m + 1, np.int64)
        np.add.at(rp, r + 1, 1)
        np.cumsum(rp, out=rp)
        return CsrMatrix(a.m, a.n, rp, np.asarray(a.colidx)[mask],
                         np.asarray(a.vals)[mask])

    return sub(dense), sub(~dense), frac


@dataclasses.dataclass(frozen=True)
class HybridPrep:
    """Prepared parts + estimates for the density-split hybrid plan."""

    dense_sorted: CsrMatrix      # compacted, length-sorted dense part
    fold_rows: np.ndarray        # dense-sorted row i → original row
    sparse: CsrMatrix            # natural-order scattered remainder
    td: int                      # dense SELL-8W tile estimate
    ts: int                      # sparse SELL-8D tile estimate
    spilled: int                 # sparse estimated straggler nnz
    nw: int                      # sparse bundle width
    dense_frac: float
    #: estimated execution cost (ns) under the dtype-aware tables — the
    #: number _plan_windowed compares against single-format plans
    cost: float = 0.0

    @property
    def tiles(self) -> int:
        return self.td + self.ts


def prepare_hybrid(a: CsrMatrix,
                   row_thresholds=(16, 32, 64, 128)
                   ) -> Optional[HybridPrep]:
    """Build the row-split hybrid's parts and routing estimates.

    Split by ROW length: heavy rows (≥ R nnz) go ENTIRELY to the compact,
    length-sorted SELL-8W part — including their scattered single-nnz
    windows, which are cheap there once the heavy rows share slices but
    poison the slot-mode layout when left in natural order (they touch
    every slice: measured powerlaw100k sparse-part estimate 15.5k tiles
    natural vs 3.6k with heavy rows removed).  Light rows ride SELL-8D
    bundles in natural order (slot mode needs no reorder).  The heavy
    output folds back with one small scatter-add (heavy rows only), NOT a
    whole-m inverse gather (~15 ns/row on the gather floor, ~0.4 ms at
    100k rows — measured via the AUTO length-sort route).

    Scans ``row_thresholds`` and keeps the cheapest under the calibrated
    cost model.  Returns None when every split is degenerate.
    """
    from .reorder import length_order, reorder_rows
    from .sell8w import estimate_sell8w_tiles
    if a.nnz == 0:
        return None
    lens = a.row_lengths.astype(np.int64)
    rows = np.repeat(np.arange(a.m, dtype=np.int64), lens)
    colidx = np.asarray(a.colidx)
    vals = np.asarray(a.vals)
    best = None
    for R in row_thresholds:
        heavy = lens >= R
        if not heavy.any() or heavy.all():
            continue
        frac = float(lens[heavy].sum()) / a.nnz
        if not (0.05 <= frac <= 0.98):
            continue
        mask = heavy[rows]
        rows_d = np.nonzero(heavy)[0]
        rp_d = np.concatenate([[0], np.cumsum(lens[heavy])])
        compact = CsrMatrix(len(rows_d), a.n, rp_d, colidx[mask],
                            vals[mask])
        perm = length_order(compact)
        dense_sorted = reorder_rows(compact, perm)
        fold_rows = rows_d[perm]
        rp_l = np.zeros(a.m + 1, np.int64)
        rp_l[1:] = np.cumsum(np.where(heavy, 0, lens))
        light = CsrMatrix(a.m, a.n, rp_l, colidx[~mask], vals[~mask])
        td = estimate_sell8w_tiles(dense_sorted)
        ts, _cap, spilled, nw = estimate_sell8d_auto(light, nw=None)
        # dtype-aware costing: double-float tiles stream two value
        # planes (+ EFT arithmetic) so the R/nw optimum shifts — f32
        # tables mis-place the split for f64 (measured powerlaw100k_f64
        # 2.49 GF/s with the f32-table split vs the 1.67x kernel ratio)
        df = np.dtype(a.dtype) == np.dtype(np.float64)
        ts_tab, spill_ns = cost_tables(a.n > _V2_MAX_N, df)
        dense_ns = dense_tile_ns(df)
        cost = (td * dense_ns + ts * ts_tab[nw] + spilled * spill_ns)
        if best is None or cost < best[0]:
            best = (cost, HybridPrep(
                dense_sorted=dense_sorted, fold_rows=fold_rows,
                sparse=light, td=int(td), ts=int(ts),
                spilled=int(spilled), nw=nw, dense_frac=frac,
                cost=float(cost)))
    return best[1] if best else None


def estimate_sell8d_tiles(a: CsrMatrix, depth_cap: Optional[int] = None,
                          nw: int = 1) -> int:
    """Lower-bound tile count: Σ over (1024-row slice, bundle) pairs of the
    max per-row nonzero count (clipped to ``depth_cap``) — ignores s-table
    conflicts (zero at scattered occupancy) and the per-slice G-padding
    (≤ g−1 per slice)."""
    if a.nnz == 0:
        return 0
    sizes, pw = _bundle_group_stats(a, int(nw).bit_length() - 1)
    if depth_cap is not None:
        sizes = np.minimum(sizes, depth_cap)
    if not np.all(pw[1:] >= pw[:-1]):
        o = np.argsort(pw, kind="stable")
        pw, sizes = pw[o], sizes[o]
    pstarts = np.nonzero(_first_of_group(pw))[0]
    return int(np.maximum.reduceat(sizes, pstarts).sum())


#: per-tile cost model for the nw chooser, CALIBRATED ON-CHIP for the
#: round-5 cell_w layout (baselines/probe_cell_w_r5*.out, uniform100k
#: co-timed): merging the nw take0 gathers before ONE take1 flattens the
#: width curve — measured marginal 12.0-13.4 / 11.1-12.8 / 10.1-13.3
#: ns/tile for nw = 2/4/8 (classic layout: 17.3 / 24.5 / 27.6-30.3).
#: nw=1 has no window loop and keeps its round-3 calibration.
_TILE_NS = {1: 20.0, 2: 13.0, 4: 12.0, 8: 12.0}
#: fixed per-grid-step cost of the slot kernel (scalar-prefetch decode +
#: output block switch), CALIBRATED ON-CHIP (baselines/probe_webbase_r4e
#: .out: the same light matrix packed at g=8 (3932 steps / 31456 tiles)
#: vs g=16 (2061 / 32976) ran 0.748 vs 0.615 ms — solving the two-point
#: system gives ~75 ns/step + ~14 ns/tile).  This is why ``g="auto"``
#: exists: per-slice padding costs ~g/2 tiles per touched slice, the
#: step cost ~_STEP_NS/g per tile — the optimum depends on tiles/slice.
_STEP_NS = 75.0
#: windowed-DMA regime (n > V2_MAX_N, x not VMEM-resident): each tile adds
#: an nw·4 KB x-window DMA (~27 ns/window at ~150 GB/s stream rate) on top
#: of the resident-mode cost — wider bundles get expensive fast here
_TILE_NS_W = {1: 47.0, 2: 74.0, 4: 128.0, 8: 236.0}
#: mirror of ops/pallas_sell.V2_MAX_N (kept host-side: formats must not
#: import the kernel module; equality pinned by tests/test_sell8d.py)
_V2_MAX_N = 2_000_000
#: fixed cost of one extra pallas_call in the striped plan (dispatch +
#: grid warm-up) — conservative placeholder pending on-chip calibration
#: (baselines/validate_slot_v2w_onchip.py re-run measures the real value)
_STRIPE_CALL_NS = 30_000.0
#: XLA straggler cost per spilled nnz — measured through the handle:
#: 51k spilled cost 0.79 ms (gather + segment-sum floor)
_SPILL_NS = 15.0
#: a bf16 value stream doubles tile bytes but rides the same DMA window —
#: measured nw=8-bf16 28.5 vs nw=4-palette 26.9 ns/tile
_VALS_NS = 4.0
#: double-float (f64) per-tile multipliers vs the f32 tables: two value
#: planes + the EFT arithmetic chain.  CALIBRATED ON-CHIP
#: (baselines/probe_df_costs.out, powerlaw100k f32/f64 co-timed on
#: identical 14184/3928-tile splits, window-normalized by the f32
#: dense 18.5-vs-20 ratio): dense 25.7 ns/tile → 1.4x; slot nw=8
#: 69.0 ns/tile → (69/0.93 − 2·_VALS_NS)/29 ≈ 2.2x.
_DF_DENSE_MULT = 1.4
_DF_SLOT_MULT = 2.2
#: df16 (int16 lo plane, the default f64 mode) slot costs, CALIBRATED
#: ON-CHIP for the cell_w layout (baselines/probe_cell_w_r5*.out,
#: uniform100k f64 co-timed): 9.7-20.5 / 19.3-19.7 / 26.6-28.3 ns/tile
#: for nw = 2/4/8 (classic: 20.5-22.8 / 28.6-31.0 / 44.6-46.1 — the
#: round-4 compute-bound problem, attacked by merging the per-plane
#: window gathers).  nw=2 take the conservative mid of a noisy pair.
#: Dense (row-mode) df16 keeps the scaled estimate.
_TILE_NS_DF16 = {1: 25.0, 2: 18.0, 4: 19.5, 8: 27.5}
_DF16_DENSE_MULT = 1.25
#: XLA straggler cost per spilled f64 nnz, measured END-TO-END through
#: the handle's compact rest path (baselines/probe_webbase_r4b.out:
#: 768 f64 stragglers cost 0.07 ms at m=100k ≈ 90 ns/nnz — any separate
#: f64 rest pathway pays m-length f64 tail ops + the XLA per-element
#: floor).  Pricing it honestly makes the cap chooser carry deep tails
#: as tiles instead of creating a rest stream that costs more.
_SPILL_NS_DF = 90.0
#: pair-level spill price: the measured end-to-end f32 straggler cost
#: at large m (probe_webbase_r4b.out: 13.2k rest nnz cost 0.37 ms at
#: m=1M ≈ 28 ns/nnz), well above the 15 ns depth-cap calibration at
#: m=100k — the round-4 rule prices pair spills conservatively so it
#: only fires on clear wins (isolated links vs deep tiles), never
#: 1-tile-vs-1-straggler washes
_PAIR_SPILL_NS = 28.0
_PAIR_SPILL_NS_DF = 100.0


def dense_tile_ns(df) -> float:
    """Per-tile cost of the row-mode (SELL-8W v2) kernel — the hybrid
    gate's dense-side unit, co-located with the slot tables so the two
    sides stay calibrated against each other."""
    if not df:
        return _TILE_NS[1]
    return _TILE_NS[1] * (_DF_DENSE_MULT if df == "df"
                          else _DF16_DENSE_MULT)


def cost_tables(windowed: bool, df):
    """(tile_ns_by_nw, spill_ns) for the (windowed-DMA, double-float)
    regime — the single source every estimator/cap chooser draws from so
    plan decisions and pack-time depth caps stay consistent.  ``df``:
    False | True (→ df16, the default f64 value mode) | "df"."""
    base = _TILE_NS_W if windowed else _TILE_NS
    if not df:
        return base, _SPILL_NS
    if df == "df":
        return ({w: v * _DF_SLOT_MULT for w, v in base.items()},
                _SPILL_NS_DF)
    if windowed:
        # windowed df16: the f32 windowed DMA curve plus the measured
        # df16 compute delta plus the second (lo) x-window plane's DMA
        # (~27 ns per 4 KB window, PERFNOTES)
        return ({w: _TILE_NS_W[w] + (_TILE_NS_DF16[w] - _TILE_NS[w])
                 + 27.0 * w for w in base}, _SPILL_NS_DF)
    return dict(_TILE_NS_DF16), _SPILL_NS_DF


def slot_stream_budget(vals: np.ndarray, nw: int, df: bool) -> float:
    """Max packed slots under the ~4 GB HBM stream budget, value-mode
    aware.  The legacy constant 6.7e8 assumed 6 B/slot (int16 meta +
    f32 value plane); palette mode stores codes INSIDE the meta
    (2 B/slot), bf16 adds a 2 B plane (4), df16 a f32-hi + int16-lo
    pair (8) — a flat slot cap blocks palette-valued packs at 3x the
    pad they actually afford (the 32M-nnz striped regime, round 4).

    f64 modes mirror _apply_values' ladder (round-4 advisor: a flat
    8 B/slot under-budgeted plain df — int16 meta + two f32 planes =
    10 B — and over-restricted palette_df by 4x, which stores only the
    2 B meta): palette_df 2 B, df16 8 B (meta + f32 hi + int16 lo),
    plain df 10 B."""
    if df:
        lb = int(nw).bit_length() - 1
        if palette_entry_count(vals) <= (64 >> lb):
            bytes_per = 2.0                        # palette_df
        elif df16_safe(np.asarray(vals)):
            bytes_per = 8.0                        # df16
        else:
            bytes_per = 10.0                       # plain df
    else:
        lb = int(nw).bit_length() - 1
        if palette_entry_count(vals) <= (64 >> lb):
            bytes_per = 2.0
        else:
            v32 = np.asarray(vals, dtype=np.float32)
            lossless = _bf16.is_lossless(v32[:1 << 20])
            if lossless and len(v32) > (1 << 20):
                lossless = _bf16.is_lossless(v32)
            bytes_per = 4.0 if lossless else 6.0
    return 4e9 / bytes_per


def palette_entry_count(vals: np.ndarray, limit: int = 65) -> int:
    """Distinct-nonzero-value count + 1 (the reserved 0 code), clipped at
    ``limit`` — the nw chooser's palette-feasibility probe.  f64 inputs
    count distinctness at full precision (palette_df stores hi+lo planes
    per entry; an f32 cast could merge distinct f64 values and declare a
    palette feasible that _apply_values would then reject)."""
    v = np.asarray(vals)
    if v.dtype != np.float64:
        v = v.astype(np.float32)
    v = v.reshape(-1)
    nz = v[v != 0.0]
    if not len(nz):
        return 1
    # cheap early-out: if a 64k sample already exceeds the limit, so does
    # the full array
    if len(nz) > 65536:
        if len(np.unique(nz[:65536])) + 1 > limit:
            return limit
    return min(len(np.unique(nz)) + 1, limit)


def estimate_sell8d_auto(a: CsrMatrix, nw: Union[int, None] = 1,
                         windowed: Optional[bool] = None,
                         max_spill: float = 0.02):
    """(tiles, cap, spilled_nnz[, nw]) under the auto depth-cap rule — the
    inspector's pre-pack cost probe (mirrors pack_sell8d's cap choice).

    With ``nw=None``, evaluates bundle widths {1, 2, 4, 8} under the
    per-tile cost model (wider bundles cost extra in-tile gathers and
    shrink the value palette to 64 >> log2(nw) entries — infeasible
    palettes pay a bf16 value stream instead) and returns the 4-tuple
    including the best nw.

    ``windowed`` switches to the windowed-DMA cost table (auto: when n
    exceeds the VMEM-resident-x envelope) — there wider bundles pay a
    real nw·4 KB DMA per tile, so the chooser leans narrow.
    """
    if a.nnz == 0:
        return (0, 0, 0) if nw is not None else (0, 0, 0, 1)
    if windowed is None:
        windowed = a.n > _V2_MAX_N
    # memoized per matrix object (frozen CsrMatrix, arrays never mutated):
    # the AUTO ladder + the round-5 striped-vs-windowed gate evaluate the
    # same (nw, windowed) points repeatedly — each costs ~0.1-1 s at 4M nnz
    cache = getattr(a, "_e8d_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(a, "_e8d_cache", cache)
    ckey = (None if nw is None else int(nw), bool(windowed),
            float(max_spill))
    if ckey in cache:
        return cache[ckey]
    df = np.dtype(a.dtype) == np.dtype(np.float64)
    _tns, _sns = cost_tables(windowed, df)
    res = None
    if (max(-(-a.m // SLICE_ROWS), 1)
            * max(-(-a.n // WINDOW), 1)) <= (1 << 28):
        # the native stats pass allocates a dense (slice, bundle) table
        from ..native import sell8d_stats_native
        res = sell8d_stats_native(
            a.m, a.n, a.rowptr, a.colidx,
            [_tns[w] for w in (1, 2, 4, 8)], _sns,
            pair_spill_ns=(_PAIR_SPILL_NS_DF if df
                           else _PAIR_SPILL_NS),
            max_spill=max_spill)
    if res is not None:
        tiles4, cap4, spill4 = res
        # one native stats pass prices ALL four widths — populate every
        # width's cache entry so per-width probe loops (graph prep's
        # light chooser) cost one call instead of four
        for wi2, w2 in enumerate((1, 2, 4, 8)):
            cache[(w2, bool(windowed), float(max_spill))] = (
                int(tiles4[wi2]), int(cap4[wi2]), int(spill4[wi2]))
        if nw is not None:
            wi = int(nw).bit_length() - 1
            r = (int(tiles4[wi]), int(cap4[wi]), int(spill4[wi]))
            cache[ckey] = r
            return r
        npal = palette_entry_count(a.vals)
        best_w = None
        for wi, w in enumerate((1, 2, 4, 8)):
            tns = _tns[w]
            if npal > (64 >> wi):
                # infeasible palette pays a raw value stream: one bf16
                # plane (f32 input) or the f32-hi + int16-lo df16 pair
                tns += 1.5 * _VALS_NS if df else _VALS_NS
            cost = tiles4[wi] * tns + spill4[wi] * _sns
            if best_w is None or cost < best_w[0]:
                best_w = (cost, wi, w)
        _, wi, w = best_w
        r = (int(tiles4[wi]), int(cap4[wi]), int(spill4[wi]), w)
        cache[ckey] = r
        return r
    choices = (int(nw),) if nw is not None else (1, 2, 4, 8)
    best = None
    rows = np.repeat(np.arange(a.m, dtype=np.int64),
                     a.row_lengths.astype(np.int64))
    npal = palette_entry_count(a.vals) if nw is None else 0
    for w in choices:
        sizes, pw = _bundle_group_stats(a, w.bit_length() - 1, rows=rows)
        if not np.all(pw[1:] >= pw[:-1]):
            o = np.argsort(pw, kind="stable")
            pw, sizes = pw[o], sizes[o]
        pstarts = np.nonzero(_first_of_group(pw))[0]
        dmax = np.maximum.reduceat(sizes, pstarts)
        cap = _cost_cap(sizes, dmax, w, tile_ns=_tns[w])
        capped = np.minimum(sizes, cap)
        spilled = int((sizes - capped).sum())
        dcap = np.minimum(dmax, cap)
        tiles = int(dcap.sum())
        # mirror the pack-time pair-level spill (round 4) so plan gates
        # see the tile counts the pack will actually realize
        kept = np.add.reduceat(capped, pstarts)
        drop = _pair_spill_set(np.arange(len(dcap)), dcap, kept, _tns[w],
                               _PAIR_SPILL_NS_DF if df
                               else _PAIR_SPILL_NS,
                               int(max_spill * a.nnz) - spilled)
        if drop is not None:
            tiles -= int(dcap[drop].sum())
            spilled += int(kept[drop].sum())
        tile_ns = _tns[w]
        if nw is None and npal > (64 >> (w.bit_length() - 1)):
            tile_ns += 1.5 * _VALS_NS if df else _VALS_NS
        cost = tiles * tile_ns + spilled * _sns
        if best is None or cost < best[0]:
            best = (cost, tiles, cap, spilled, w)
    _, tiles, cap, spilled, w = best
    r = (tiles, cap, spilled) if nw is not None \
        else (tiles, cap, spilled, w)
    cache[ckey] = r
    return r
