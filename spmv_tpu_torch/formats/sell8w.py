"""SELL-8W: the windowed-gather SELL format for the Pallas kernel
(a copy of ``spmv_tpu/formats/sell8w.py`` with ``ml_dtypes`` replaced by
:mod:`._bf16`: bf16 arrays are uint16 bit arrays here; pinned by
``tests/test_torch_formats.py``).

The Mosaic TPU compiler only lowers gathers on exact (8,128) tiles
(PERFNOTES.md), so a kernel tile can read an arbitrary aligned 1024-element
x-window — ``x2[8w:8w+8, :]`` of ``x2 = x.reshape(-1, 128)`` — through the
two-stage gather ``take_along_axis(take_along_axis(win, sidx, 0), ridx, 1)``.
This module packs a CSR matrix into the tile stream that kernel consumes:

* slices of 128 rows (rows = lanes, natural order — no σ-sort, so the output
  needs no inverse permutation);
* each tile (8, 128) holds ≤ 8 nonzeros per lane, all with columns inside
  ONE window ``w``;
* slot assignment must satisfy the gather-consistency constraint: within a
  sublane row ``i``, every slot with residue ``r`` must read the same window
  sub-row ``s`` (because the first gather builds ``t1[i, l] =
  win[sidx[i, l], l]`` — one ``s`` per (sublane, residue));
* per-slot metadata packs (s, r) into one int16: ``s << 7 | r``.

Tiles are emitted slice-major (all tiles of slice 0, then slice 1, …) so the
kernel can accumulate per-slice output blocks.  Padding slots have value 0
and point at (s=0, r=0) — gathered garbage × 0 = 0.

The per-element greedy placement is the pack-time analog of the reference's
SELL σ-window sort + tile pack (sell_C_Sigma_spmv.c:141-247), with the
sorting objective replaced by window-locality (which the reorder layer
optimizes, formats/reorder.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..types import CsrMatrix, INT_DTYPE
from . import _bf16

__all__ = ["Sell8W", "Sell8WV2", "pack_sell8w", "plan_v2",
           "estimate_sell8w_tiles", "pairs_lower_bound", "value_palette",
           "split_megarows", "split_stragglers", "df16_encode_lo",
           "df16_safe"]

LANES = 128
SUB = 8
WINDOW = 1024          # = SUB * LANES, one (8,128) block of x2


@dataclasses.dataclass(frozen=True)
class Sell8W:
    m: int
    n: int
    nnz_stored: int
    nslices: int           # ceil(m / 128)
    ntiles: int
    window_ids: np.ndarray   # (ntiles,) int32 — x2 block row (w) per tile
    slice_ids: np.ndarray    # (ntiles,) int32 — owning slice, non-decreasing
    meta: np.ndarray         # (ntiles, 8, 128) int16 — s<<7 | r per slot
    vals: np.ndarray         # (ntiles, 8, 128) float32

    @property
    def pad_ratio(self) -> float:
        return self.ntiles * WINDOW / max(self.nnz_stored, 1)


@dataclasses.dataclass(frozen=True)
class Sell8WV2:
    """Grouped tile stream for the v2 kernel (ops/pallas_sell.py v2 path).

    The v1 kernel pays a per-grid-step cost that dominates at one tile per
    step (measured ~250 ns/step on the v5e — baselines/probe_step.out); v2
    processes ``G`` tiles per step with x resident in VMEM, and compresses
    the values stream: a ≤64-entry **value palette** rides spare meta bits
    (the values stream disappears — 2 KB/tile instead of 6), else bf16 when
    every value round-trips (4 KB), else f32.  The reference's own
    benchmark values are k/8 dyadics (test_spmv.c:200) — an 8-entry palette.
    """

    m: int
    n: int
    nnz_stored: int
    nslices: int
    g: int                     # tiles per grid step
    ntiles: int                # padded to G per slice-group
    nsteps: int
    # "palette" | "bf16" | "f32" | "df" | "df16" | "palette_df"
    value_mode: str
    tinfo: np.ndarray          # (ntiles,) int32: window << 3 | row_in_group
    ginfo: np.ndarray          # (nsteps,) int32: group << 1 | first_flag
    meta: np.ndarray           # (ntiles, 8, 128) int16 (s<<7|r | code<<10)
    vals: Optional[np.ndarray]  # (ntiles, 8, 128) f32/bf16, None for palette
    palette: Optional[np.ndarray]  # (128,) f32, palette[0] == 0
    # double-float (f64 ≈ hi + lo) extras — None outside df modes.  vals_lo
    # is f32 in "df" mode, int16 quantized lo mantissas in "df16" (default
    # f64 mode — see df16_encode_lo)
    vals_lo: Optional[np.ndarray] = None
    palette_lo: Optional[np.ndarray] = None  # (128,) f32

    @property
    def pad_ratio(self) -> float:
        return self.ntiles * WINDOW / max(self.nnz_stored, 1)


def df16_encode_lo(vhi: np.ndarray, vlo: np.ndarray) -> np.ndarray:
    """Quantize a double-float lo plane to int16 (the "df16" value mode).

    Encodes ``vlo ≈ q · 2^(e−39)`` where ``2^e = floor-pow2(|vhi|)`` — the
    kernel recovers the scale from vhi's exponent bits (one bitcast + mask,
    ops/pallas_sell._df16_decode), so the lo stream carries NO exponent.
    Since ``|vlo| ≤ ulp(vhi)/2 = 2^(e−24)``, ``|q| ≤ 2^15`` (clipped to
    32767 at the exact-half-ulp edge, one quantum of loss).  Value
    precision ≈ 24 + 16 = 40 mantissa bits vs 48 for the full f32 lo plane
    at HALF its bytes — the df tile stream drops 10 → 8 KB/tile, and the
    kernels are stream-bound (PERFNOTES.md round-3 df multipliers).

    The reference computes f64 natively (include/spmv.h:49); TPU VPUs have
    no f64, so "own dtype" here is the documented double-float ladder:
    df ≈ 2^-45 worst-case value representation, df16 ≈ 2^-40.  Out-of-range
    inputs (|vhi| subnormal-adjacent or non-finite) drop the lo part —
    :func:`df16_safe` gates the mode off for those matrices.
    """
    vh = np.asarray(vhi, dtype=np.float32)
    shape = vh.shape
    vh = vh.reshape(-1)
    vl = np.asarray(vlo).reshape(-1)
    out = np.zeros(vh.shape, dtype=np.int16)
    # tile streams are mostly padding zeros (pad_ratio × fewer real
    # slots); vhi == 0 implies vlo == 0 under the df16_safe contract
    # (|v| ≥ 2^-100 keeps f32(v) normal), so encode the nonzero subset
    # only — measured 3.7 s → <1 s on the powerlaw f64 predeal (round 5)
    nz = np.nonzero(vh)[0]
    vh64 = vh[nz].astype(np.float64)
    _, e = np.frexp(vh64)
    step = np.ldexp(1.0, e - 40)       # floor-pow2(|vhi|) · 2^-39
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        q = np.rint(vl[nz].astype(np.float64) / step)
    # the kernel decodes subnormal/zero/non-finite vhi to scale 0 — encode
    # the same slots to 0 so both sides agree (lo loss ≤ 2^-125 absolute)
    bad = ~np.isfinite(vh64) | (np.abs(vh64) < 2.0 ** -100)
    q = np.where(bad | ~np.isfinite(q), 0.0, q)
    out[nz] = np.clip(q, -32767, 32767).astype(np.int16)
    return out.reshape(shape)


def df16_safe(vals: np.ndarray) -> bool:
    """True when every value sits where df16 keeps its 40-bit contract:
    finite, and either exactly 0 or |v| ≥ 2^-100 (far above f32
    subnormals, where the exponent-bit scale recovery degrades)."""
    v = np.asarray(vals).reshape(-1)
    if not np.isfinite(v).all():
        return False
    av = np.abs(v)
    return bool(((av == 0) | (av >= 2.0 ** -100)).all())


def value_palette(vals: np.ndarray, max_entries: int = 64):
    """(palette, codes) with palette[0] == 0.0, or None if > max_entries
    distinct values.  Palette is padded to 128 lanes for the kernel's
    take_along_axis decode.

    Works on the nonzero subset only: tile streams are mostly padding
    zeros at high pad ratios, and a full-array unique/searchsorted cost
    ~13 s at 78M slots (uniform100k) vs ~1 s this way."""
    v = np.ascontiguousarray(vals, dtype=np.float32).reshape(-1)
    mask = v != 0.0
    nz = v[mask]
    uniq = np.unique(nz)
    if len(uniq) + 1 > max_entries:
        return None
    palette = np.zeros(LANES, dtype=np.float32)
    palette[1: 1 + len(uniq)] = uniq
    codes = np.zeros(v.shape, dtype=np.int16)
    codes[mask] = (np.searchsorted(uniq, nz) + 1).astype(np.int16)
    return palette, codes


def plan_v2(p: Sell8W, g: int = 16,
            lo_tiles: Optional[np.ndarray] = None,
            force_value_mode: Optional[str] = None) -> Sell8WV2:
    """Regroup a v1 tile stream for the v2 kernel.

    Pads each slice-GROUP's tile run to a multiple of ``g`` with zero tiles
    (value 0 ⇒ contributes nothing) so no grid step straddles an output
    block, picks the value mode, and packs palette codes into meta bits
    10-15.

    ``lo_tiles``: the f64 path — (ntiles,8,128) f32 low parts such that the
    stored f64 value ≈ vals + lo_tiles (double-float).  The greedy placement
    is value-independent, so the caller obtains it by packing the SAME
    matrix twice (vals=hi, vals=lo) — identical slots guaranteed.  Selects
    value_mode "palette_df" (≤64 distinct f64 values — both palettes ride
    one meta code), else "df16" (int16 quantized lo plane, ~40-bit values,
    the default — see :func:`df16_encode_lo`), else "df" when df16's range
    contract fails or ``force_value_mode="df"`` asks for the full 48-bit
    lo plane.
    """
    if force_value_mode not in (None, "df", "df16", "palette_df"):
        raise ValueError(f"unknown plan_v2 value mode {force_value_mode!r}")
    ngroups = max(-(-p.nslices // SUB), 1)
    groups = p.slice_ids.astype(np.int64) // SUB
    # run lengths per group (slice-major order; every group covered ≥ 1)
    counts = np.bincount(groups, minlength=ngroups)
    padded = np.maximum(-(-counts // g) * g, g)
    ntiles = int(padded.sum())
    starts = np.concatenate([[0], np.cumsum(padded)[:-1]])
    dest = starts[groups] + (np.arange(p.ntiles)
                             - np.concatenate([[0], np.cumsum(counts)[:-1]])[groups])

    # meta is scattered exactly once per mode below (palette modes merge
    # codes on the v1 layout first) — a second full-array pass costs ~2 s
    # at 78M slots on this host
    meta = np.zeros((ntiles, SUB, LANES), dtype=np.int16)
    tinfo = np.zeros(ntiles, dtype=np.int32)
    tinfo[dest] = (p.window_ids.astype(np.int64) << 3
                   | (p.slice_ids.astype(np.int64) % SUB)).astype(np.int32)

    vals = None
    vals_lo = None
    palette = None
    palette_lo = None
    if lo_tiles is not None:
        # f64 double-float path: hi/lo f32 pairs, same slot layout.
        # Distinctness/range checks run on the NONZERO slots only — the
        # padded stream is pad_ratio × larger than the real payload, and
        # a 64k sample early-outs the (rare) palette check before a full
        # unique (round-5 predeal profile: the full-stream f64 temporaries
        # cost ~2 s per f64 family)
        hi_flat = p.vals.reshape(-1)
        nzmask = hi_flat != 0
        v64nz = (hi_flat[nzmask].astype(np.float64)
                 + lo_tiles.reshape(-1)[nzmask].astype(np.float64))
        many = (len(v64nz) > 65536
                and len(np.unique(v64nz[:65536])) > 64)
        uniq = (np.empty(65, np.float64) if many
                else np.unique(v64nz))
        uniq = uniq[:65] if many else uniq[uniq != 0.0]
        if len(uniq) + 1 <= 64 and force_value_mode in (None, "palette_df"):
            v64 = np.zeros(hi_flat.shape, np.float64)
            v64[nzmask] = v64nz
            # exact-f64 palette, split into hi/lo decode rows
            pal_f64 = np.zeros(LANES, dtype=np.float64)
            pal_f64[1: 1 + len(uniq)] = uniq
            codes = np.searchsorted(uniq, v64) + 1
            codes[v64 == 0.0] = 0
            palette = pal_f64.astype(np.float32)
            palette_lo = (pal_f64 - palette.astype(np.float64)) \
                .astype(np.float32)
            value_mode = "palette_df"
            merged = ((p.meta.view(np.uint16) & np.uint16(0x3FF))
                      | np.left_shift(
                          codes.astype(np.uint16)
                          .reshape(p.ntiles, SUB, LANES), np.uint16(10)))
            meta[dest] = merged.view(np.int16)
        else:
            if force_value_mode == "palette_df":
                raise ValueError("palette_df value mode forced but > 64 "
                                 "distinct values")
            # zeros are df16-safe by definition — check the real payload
            use16 = (df16_safe(v64nz) if force_value_mode is None
                     else force_value_mode == "df16")
            if use16 and force_value_mode == "df16" \
                    and not df16_safe(v64nz):
                raise ValueError("df16 value mode forced but values are "
                                 "outside its normal-range contract")
            value_mode = "df16" if use16 else "df"
            meta[dest] = p.meta
            vals = np.zeros((ntiles, SUB, LANES), dtype=np.float32)
            vals[dest] = p.vals.astype(np.float32)
            if use16:
                vals_lo = np.zeros((ntiles, SUB, LANES), dtype=np.int16)
                vals_lo[dest] = df16_encode_lo(p.vals, lo_tiles)
            else:
                vals_lo = np.zeros((ntiles, SUB, LANES), dtype=np.float32)
                vals_lo[dest] = lo_tiles.astype(np.float32)
        nsteps = ntiles // g
        sg = np.repeat(np.arange(ngroups, dtype=np.int64), padded // g)
        first = np.ones(nsteps, dtype=np.int64)
        first[1:] = (sg[1:] != sg[:-1]).astype(np.int64)
        ginfo = (sg << 1 | first).astype(np.int32)
        return Sell8WV2(
            m=p.m, n=p.n, nnz_stored=p.nnz_stored, nslices=p.nslices,
            g=g, ntiles=ntiles, nsteps=nsteps, value_mode=value_mode,
            tinfo=tinfo, ginfo=ginfo, meta=meta, vals=vals,
            palette=palette, vals_lo=vals_lo, palette_lo=palette_lo)

    pal = value_palette(p.vals.reshape(-1))
    if pal is not None:
        palette, codes = pal
        value_mode = "palette"
        # merge codes into bits 10-15 on the v1 layout in uint16 (the int64
        # full-array merge this replaces cost ~7 s / ~1.3 GB of temporaries
        # at 78M slots), then place with the single scatter
        merged = ((p.meta.view(np.uint16) & np.uint16(0x3FF))
                  | np.left_shift(
                      codes.view(np.uint16).reshape(p.ntiles, SUB, LANES),
                      np.uint16(10)))
        meta[dest] = merged.view(np.int16)
    else:
        meta[dest] = p.meta
        v32 = p.vals.astype(np.float32)
        lossless = _bf16.is_lossless(v32)
        value_mode = "bf16" if lossless else "f32"
        dt = np.uint16 if lossless else np.float32
        vals = np.zeros((ntiles, SUB, LANES), dtype=dt)
        vals[dest] = _bf16.from_f32(v32) if lossless else v32

    nsteps = ntiles // g
    sg = np.repeat(np.arange(ngroups, dtype=np.int64), padded // g)
    first = np.ones(nsteps, dtype=np.int64)
    first[1:] = (sg[1:] != sg[:-1]).astype(np.int64)
    ginfo = (sg << 1 | first).astype(np.int32)

    return Sell8WV2(
        m=p.m, n=p.n, nnz_stored=p.nnz_stored, nslices=p.nslices,
        g=g, ntiles=ntiles, nsteps=nsteps, value_mode=value_mode,
        tinfo=tinfo, ginfo=ginfo, meta=meta, vals=vals, palette=palette)


def estimate_sell8w_tiles(a: CsrMatrix) -> int:
    """Cheap lower-bound tile count (no consistency conflicts accounted):
    per (slice, window): max(ceil(max-lane-count/8), ceil(total/1024)).
    Fully vectorized (runs inside featurize for every AUTO handle).

    Memoized on the matrix object: the AUTO ladder (inspector features,
    plan gates, hybrid/graph preps) calls this up to 9× per handle —
    0.3 s each at 4M nnz (round-5 predeal profile).  CsrMatrix is frozen
    and its arrays are never mutated in place, so the cache is sound."""
    if a.nnz == 0:
        return 0
    cached = getattr(a, "_t8w_cache", None)
    if cached is not None:
        return cached
    rows = np.repeat(np.arange(a.m, dtype=np.int64), a.row_lengths)
    sl = rows // LANES
    w = a.colidx.astype(np.int64) // WINDOW
    lane = rows % LANES
    nwin = a.n // WINDOW + 2
    key_sw = sl * nwin + w
    key_swl = key_sw * LANES + lane
    # per-(slice,window,lane) counts, then per-(slice,window) max and total
    uswl, lane_counts = np.unique(key_swl, return_counts=True)
    usw_of_lane = uswl // LANES
    # group max over sorted usw_of_lane (np.maximum.reduceat)
    first = np.concatenate([[0], np.nonzero(np.diff(usw_of_lane))[0] + 1])
    max_lane = np.maximum.reduceat(lane_counts, first)
    usw, totals = np.unique(key_sw, return_counts=True)
    # usw and usw_of_lane[first] enumerate the same groups in the same order
    tiles = np.maximum(-(-max_lane // SUB), -(-totals // WINDOW))
    result = int(tiles.sum())
    object.__setattr__(a, "_t8w_cache", result)
    return result


def split_megarows(a: CsrMatrix, max_len: Optional[int] = None):
    """(a_ext, sub_rows) or (a, None): virtual intra-row splitting.

    Heavy-tailed matrices pack terribly in SELL-8W natural order: a
    mega-row's nonzeros all share one lane, forcing ~len/(8·nwin)
    nearly-empty tiles per window (measured powerlaw100k pad estimate 111).
    Rows longer than ``max_len`` (default 8·nwin ≈ one full tile depth per
    window) are cut into column-contiguous sub-rows appended as extra rows
    ``m..m_ext``; each sub-row inherits the sorted-column locality of its
    chunk, so the extras pack densely.  ``sub_rows[j]`` is the origin row
    of extra row ``m + j`` — the executor folds them back with one tiny
    scatter-add (nsub values), so unlike a length-sort reorder there is no
    per-execution permutation gather of x or y.

    This is the reference Balanced2's mega-row redistribution + intra-row
    split (parallel_balanced2_spmv.c:115-198) re-expressed at the format
    level.
    """
    if a.nnz == 0:
        return a, None
    nwin = max(-(-a.n // WINDOW), 1)
    if max_len is None:
        max_len = max(SUB * nwin, 64)
    lens = a.row_lengths.astype(np.int64)
    heavy = np.nonzero(lens > max_len)[0]
    if len(heavy) == 0:
        return a, None
    row_of = np.repeat(np.arange(a.m, dtype=np.int64), lens)
    is_heavy_nnz = lens[row_of] > max_len
    nsub = -(-lens[heavy] // max_len)
    sub_rows = np.repeat(heavy, nsub)
    # sub-row lengths: max_len except each heavy row's tail
    sub_lens = np.full(int(nsub.sum()), max_len, dtype=np.int64)
    tails = np.cumsum(nsub) - 1
    sub_lens[tails] = lens[heavy] - (nsub - 1) * max_len
    new_lens = np.concatenate([np.where(lens > max_len, 0, lens), sub_lens])
    rowptr = np.zeros(len(new_lens) + 1, dtype=np.int64)
    np.cumsum(new_lens, out=rowptr[1:])
    # nnz order: light nonzeros keep row order; heavy nonzeros, extracted
    # in row order, are already laid out sub-row-contiguously
    colidx = np.concatenate([a.colidx[~is_heavy_nnz],
                             a.colidx[is_heavy_nnz]])
    vals = np.concatenate([a.vals[~is_heavy_nnz], a.vals[is_heavy_nnz]])
    a_ext = CsrMatrix(a.m + len(sub_rows), a.n,
                      rowptr.astype(a.rowptr.dtype), colidx, vals)
    return a_ext, sub_rows.astype(INT_DTYPE)


def split_stragglers(a: CsrMatrix, min_pair: int = 12):
    """Hybrid split: (a_main, (rows, cols, vals) remainder, rest_frac).

    Every populated (slice, window) pair costs at least one full (8,128)
    tile, so a sprinkle of long-range edges (community graphs' inter-cluster
    links, power-law stragglers) can dominate the padding.  Pairs with fewer
    than ``min_pair`` nonzeros are split out for the XLA gather path — the
    ELL+COO hybrid, TPU-style.  O(nnz), sortless.
    """
    if a.nnz == 0:
        return a, None, 0.0
    nslices = -(-a.m // LANES)
    nwin = -(-a.n // WINDOW)
    rows = np.repeat(np.arange(a.m, dtype=np.int64), a.row_lengths)
    key = (rows // LANES) * nwin + a.colidx.astype(np.int64) // WINDOW
    if nslices * nwin > (1 << 28):
        return a, None, 0.0                 # pair space too large to count
    counts = np.bincount(key, minlength=nslices * nwin)
    straggler = counts[key] < min_pair
    frac = float(straggler.mean())
    if frac == 0.0:
        return a, None, 0.0
    keep = ~straggler
    lengths = np.bincount(rows[keep], minlength=a.m)
    rowptr = np.zeros(a.m + 1, dtype=np.int64)
    np.cumsum(lengths, out=rowptr[1:])
    a_main = CsrMatrix(a.m, a.n, rowptr.astype(INT_DTYPE),
                       a.colidx[keep], a.vals[keep])
    rest = (rows[straggler].astype(INT_DTYPE), a.colidx[straggler],
            a.vals[straggler])
    return a_main, rest, frac


def split_offpalette(a: CsrMatrix, max_entries: int = 64,
                     max_frac: float = 0.01):
    """Palette-with-exceptions split: (a_main, (rows, cols, vals) or None).

    Exact-valued matrices (the reference's k/8 fixture, test_spmv.c:200)
    grow a long tail of distinct values where duplicate (row, col) entries
    are summed at load (webbase: 8 base values, 429 distinct after
    summing) — value_palette then rejects the WHOLE stream and the plan
    ships a full f32 value plane (4 KB/tile, measured 21 vs ~10 ns/tile
    on the webbase heavy part, probe_webbase_r4e).  Keeping the
    ``max_entries - 1`` most frequent values in-palette and moving the
    exceptions (webbase: 1,433 of 1.32M nnz) to the XLA rest stream
    restores palette mode for the 99.9%.

    Returns ``(a, None)`` when the palette already fits (≤ ``max_entries``
    distinct) or when exceptions exceed ``max_frac`` — then the split
    would cost more on the rest stream than the value plane it saves.
    """
    v = np.ascontiguousarray(a.vals, dtype=np.float32)
    nz = v[v != 0.0]
    if not len(nz):
        return a, None
    uniq, counts = np.unique(nz, return_counts=True)
    if len(uniq) + 1 <= max_entries:
        return a, None
    order = np.argsort(counts)[::-1]
    keep_vals = np.sort(uniq[order[: max_entries - 1]])
    pos = np.searchsorted(keep_vals, v)
    pos = np.minimum(pos, len(keep_vals) - 1)
    off = (keep_vals[pos] != v) & (v != 0.0)
    n_off = int(off.sum())
    if n_off == 0 or n_off > max_frac * a.nnz:
        return a, None
    rows = np.repeat(np.arange(a.m, dtype=np.int64), a.row_lengths)
    keep = ~off
    lengths = np.bincount(rows[keep], minlength=a.m)
    rowptr = np.zeros(a.m + 1, dtype=np.int64)
    np.cumsum(lengths, out=rowptr[1:])
    a_main = CsrMatrix(a.m, a.n, rowptr.astype(INT_DTYPE),
                       a.colidx[keep], a.vals[keep])
    rest = (rows[off].astype(INT_DTYPE), a.colidx[off], a.vals[off])
    return a_main, rest


def pairs_lower_bound(a: CsrMatrix) -> int:
    """Sortless lower bound on tile count: distinct (slice, window) pairs.

    O(nnz) bincount when the pair space fits; otherwise an exact sort-based
    unique over the nnz keys (seconds at multi-M nnz, but only huge m·n
    matrices land there — ADVICE round 2: returning 0/unknown silently
    disabled the AUTO→CSR5 route for exactly those matrices).
    """
    if a.nnz == 0:
        return 0
    nslices = -(-a.m // LANES)
    nwin = -(-a.n // WINDOW)
    rows = np.repeat(np.arange(a.m, dtype=np.int64), a.row_lengths)
    key = (rows // LANES) * nwin + a.colidx.astype(np.int64) // WINDOW
    if nslices * nwin > (1 << 28):
        return len(np.unique(key))
    return int(np.count_nonzero(np.bincount(key, minlength=nslices * nwin)))


def pack_sell8w(a: CsrMatrix, max_pad_ratio: Optional[float] = None,
                use_native: bool = True) -> Sell8W:
    """Greedy tile packing.  Raises ValueError if the padding would exceed
    ``max_pad_ratio`` (the handle falls back to an XLA plan then).

    Uses the C++ packer (native/spmv_native.cpp) when available — same
    greedy, ~30× faster on multi-million-nnz matrices — else pure numpy.
    """
    nslices = max(-(-a.m // LANES), 1)
    if max_pad_ratio is not None and a.nnz:
        # sortless lower-bound gate: refuse exploding packings before
        # materializing them (uniform-wide matrices would allocate GBs)
        lb = pairs_lower_bound(a)
        if lb * WINDOW / a.nnz > max_pad_ratio:
            raise ValueError(
                f"sell8w padding lower bound {lb * WINDOW / a.nnz:.2f} "
                f"exceeds max_pad_ratio={max_pad_ratio}")
    if use_native:
        # No sort-based pre-estimate on the native path: the packer is fast
        # enough that the exact post-pack pad check is the gate (the
        # estimate pass cost ~2.6 s at 6M nnz on this host).
        from ..native import pack_sell8w_native
        packed = pack_sell8w_native(a.m, a.n, a.rowptr, a.colidx, a.vals)
        if packed is not None:
            window_ids, slice_ids, meta, vtiles = packed
            out = Sell8W(m=a.m, n=a.n, nnz_stored=a.nnz, nslices=nslices,
                         ntiles=len(window_ids), window_ids=window_ids,
                         slice_ids=slice_ids, meta=meta, vals=vtiles)
            if (max_pad_ratio is not None and a.nnz
                    and out.pad_ratio > max_pad_ratio):
                raise ValueError(
                    f"sell8w pad_ratio {out.pad_ratio:.2f} exceeds "
                    f"max_pad_ratio={max_pad_ratio}")
            return out
    if max_pad_ratio is not None and a.nnz:
        # python greedy is slow on exploding packings — gate on the estimate
        est = estimate_sell8w_tiles(a)
        if est * WINDOW / a.nnz > max_pad_ratio:
            raise ValueError(
                f"sell8w padding estimate {est * WINDOW / a.nnz:.2f} exceeds "
                f"max_pad_ratio={max_pad_ratio}")
    rows = np.repeat(np.arange(a.m, dtype=np.int64), a.row_lengths)
    cols = a.colidx.astype(np.int64)
    lane = (rows % LANES).astype(np.int32)
    sl = (rows // LANES).astype(np.int32)
    w = (cols // WINDOW).astype(np.int32)
    s_in = ((cols % WINDOW) // LANES).astype(np.int8)
    r_in = (cols % LANES).astype(np.int8)
    vals = a.vals.astype(np.float32)

    # order elements by (slice, window) with stable lane grouping
    order = np.lexsort((lane, w, sl))
    sl, w, lane, s_in, r_in, vals = (arr[order] for arr in
                                     (sl, w, lane, s_in, r_in, vals))

    tiles_w, tiles_s, tiles_meta, tiles_vals = [], [], [], []
    # group boundaries over (slice, window)
    if a.nnz:
        key = sl.astype(np.int64) * (int(w.max()) + 2) + w
        bounds = np.concatenate([[0], np.nonzero(np.diff(key))[0] + 1,
                                 [len(key)]])
    else:
        bounds = np.array([0])

    for b in range(len(bounds) - 1):
        lo, hi = int(bounds[b]), int(bounds[b + 1])
        g_lane = lane[lo:hi]
        g_s = s_in[lo:hi]
        g_r = r_in[lo:hi]
        g_v = vals[lo:hi]
        pending = list(range(hi - lo))
        while pending:
            # Two channels share the int16 tile but use DIFFERENT layouts —
            # exactly how the kernel reads them (ops/pallas_sell.py):
            #   low 7 bits at slot (i, j)      = element j-in-sublane-i's
            #                                    residue r (take_along dim1);
            #   high bits at slot (i, l)       = staging row s for RESIDUE l
            #                                    in sublane i (take_along
            #                                    dim0 runs BEFORE dim1, so
            #                                    its index is per-residue).
            rslot = np.zeros((SUB, LANES), dtype=np.int16)
            vtile = np.zeros((SUB, LANES), dtype=np.float32)
            # per (sublane, residue) assigned s; -1 = unset
            stab = np.full((SUB, LANES), -1, dtype=np.int16)
            lane_used = np.zeros((SUB, LANES), dtype=bool)
            overflow = []
            for e in pending:
                j, s_e, r_e = int(g_lane[e]), int(g_s[e]), int(g_r[e])
                for i in range(SUB):
                    if not lane_used[i, j] and stab[i, r_e] in (-1, s_e):
                        lane_used[i, j] = True
                        stab[i, r_e] = s_e
                        rslot[i, j] = r_e
                        vtile[i, j] = g_v[e]
                        break
                else:
                    overflow.append(e)
            meta = (np.maximum(stab, 0) << 7) | rslot
            tiles_w.append(w[lo])
            tiles_s.append(sl[lo])
            tiles_meta.append(meta.astype(np.int16))
            tiles_vals.append(vtile)
            pending = overflow

    # Every slice-GROUP (8 slices = one kernel output block) must own at
    # least one tile, else its output block is never zero-initialized by the
    # kernel.  Insert zero tiles for uncovered groups, keeping slice-major
    # order (the kernel requires non-decreasing slice ids).
    ngroups = -(-nslices // SUB)
    covered = {int(s) // SUB for s in tiles_s}
    for g in range(ngroups):
        if g not in covered:
            tiles_w.append(0)
            tiles_s.append(g * SUB)
            tiles_meta.append(np.zeros((SUB, LANES), np.int16))
            tiles_vals.append(np.zeros((SUB, LANES), np.float32))
    order_t = np.argsort(np.asarray(tiles_s), kind="stable")
    tiles_w = [tiles_w[i] for i in order_t]
    tiles_s = [tiles_s[i] for i in order_t]
    tiles_meta = [tiles_meta[i] for i in order_t]
    tiles_vals = [tiles_vals[i] for i in order_t]
    ntiles = len(tiles_meta)

    out = Sell8W(
        m=a.m, n=a.n, nnz_stored=a.nnz, nslices=nslices, ntiles=ntiles,
        window_ids=np.asarray(tiles_w, dtype=INT_DTYPE),
        slice_ids=np.asarray(tiles_s, dtype=INT_DTYPE),
        meta=np.stack(tiles_meta),
        vals=np.stack(tiles_vals),
    )
    if max_pad_ratio is not None and a.nnz and out.pad_ratio > max_pad_ratio:
        raise ValueError(f"sell8w pad_ratio {out.pad_ratio:.2f} exceeds "
                         f"max_pad_ratio={max_pad_ratio}")
    return out
