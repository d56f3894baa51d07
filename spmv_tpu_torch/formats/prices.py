"""The planner's price table: one frozen :class:`Prices` read by every cost
the router computes (``sell8d.cost_tables``, ``dense_tile_ns``,
``stripe_overhead_ns``, ``_cost_cap``, ``_choose_g``, the pair spill rule,
the graph split's cost and its heavy straggler split).

Two tables:

* :data:`REFERENCE`, the JAX package's values (``spmv_tpu/formats/
  sell8d.py`` and ``formats/graph.py``), kept so that the port's routes
  match ``spmv_tpu``'s; the default wherever ``prices=None``;
* :data:`H100`, derived on an NVIDIA H100 by :func:`derive_prices` from the
  figures that ``spmv_tpu_torch/bench/probes.py`` measures
  (``chip_smoke.py``'s ``prices`` phase prints both).  Opt-in:
  ``create_handle(..., prices=H100)``, ``build_dist_auto(..., prices=H100)``.

Every time is in ns.  A table by bundle width is a tuple over
:data:`NWS`; :meth:`Prices.by_nw` gives it as a dict.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

__all__ = ["Prices", "REFERENCE", "H100", "NWS", "table", "derive_prices"]

#: the bundle widths a by-width table covers, in order
NWS = (1, 2, 4, 8)

Table = Tuple[float, float, float, float]


@dataclasses.dataclass(frozen=True)
class Prices:
    """Every constant that prices a plan."""

    #: a slot-mode (SELL-8D) tile by bundle width, x resident
    tile_ns: Table
    #: a row-mode (SELL-8W v2) tile: the hybrid's dense side, the graph
    #: split's heavy rows
    row_tile_ns: float
    #: one grid step of the slot kernel (``_choose_g``'s step term)
    step_ns: float
    #: a slot-mode tile past V2_MAX_N columns (the windowed kernels)
    tile_ns_w: Table
    #: one extra kernel call of the striped plan
    stripe_call_ns: float
    #: the striped plan's x term: ns a byte of x (``n * 4`` bytes)
    stripe_x_ns_per_byte: float
    #: a straggler (rest-stream) nonzero, f32
    spill_ns: float
    #: a bf16 value plane on a tile whose palette does not fit
    vals_ns: float
    #: double-float multipliers over the f32 tiles: row mode in df, slot
    #: mode in df, row mode in df16
    df_dense_mult: float
    df_slot_mult: float
    df16_dense_mult: float
    #: a df16 slot tile by bundle width
    tile_ns_df16: Table
    #: the windowed df16 tile's second x plane, a window of 4 KB
    x_window_ns: float
    #: a straggler nonzero, f64
    spill_ns_df: float
    #: the pair-level spill rule's price a nonzero, f32 and f64
    pair_spill_ns: float
    pair_spill_ns_df: float
    #: the graph split: a heavy row's fold scatter-add, a hub column's
    #: x gather
    fold_ns: float
    hub_ns: float
    #: the depth cap is the cheapest of those whose straggler tail fits
    #: the pack's spill gate (``max_spill``); False is the JAX planner's
    #: rule, the cheapest outright.  Under a straggler price far below a
    #: tile's, that rule spills past every SELL route's gate and leaves
    #: AUTO the tiled scan.
    cap_within_gate: bool

    @staticmethod
    def by_nw(tab: Table) -> Dict[int, float]:
        """A by-width tuple as ``{nw: ns}``."""
        return dict(zip(NWS, tab))


#: The JAX package's values (``spmv_tpu/formats/sell8d.py`` ``_TILE_NS``,
#: ``_STEP_NS``, ``_TILE_NS_W``, ``_STRIPE_CALL_NS``, ``stripe_overhead_ns``'
#: 0.027, ``_SPILL_NS``, ``_VALS_NS``, ``_DF_DENSE_MULT``, ``_DF_SLOT_MULT``,
#: ``_DF16_DENSE_MULT``, ``_TILE_NS_DF16``, ``cost_tables``' 27.0,
#: ``_SPILL_NS_DF``, ``_PAIR_SPILL_NS``, ``_PAIR_SPILL_NS_DF``, and
#: ``_TILE_NS[1]`` again as the row-mode tile;
#: ``spmv_tpu/formats/graph.py`` ``_FOLD_NS``, ``_HUB_NS``), kept so that
#: the port's routes are ``spmv_tpu``'s (``tests/test_torch_prices.py``
#: holds them equal field by field).
REFERENCE = Prices(
    tile_ns=(20.0, 13.0, 12.0, 12.0), row_tile_ns=20.0, step_ns=75.0,
    tile_ns_w=(47.0, 74.0, 128.0, 236.0), stripe_call_ns=30_000.0,
    stripe_x_ns_per_byte=0.027, spill_ns=15.0, vals_ns=4.0,
    df_dense_mult=1.4, df_slot_mult=2.2, df16_dense_mult=1.25,
    tile_ns_df16=(25.0, 18.0, 19.5, 27.5), x_window_ns=27.0,
    spill_ns_df=90.0, pair_spill_ns=28.0, pair_spill_ns_df=100.0,
    fold_ns=15.0, hub_ns=8.0, cap_within_gate=False)

#: Derived by :func:`derive_prices` from one run of ``chip_smoke.py``'s
#: ``prices`` phase (through ``bench/probes.py``; the table its
#: ``prices_calibration`` prints), on 2026-10-17 on an NVIDIA H100 80GB
#: HBM3 at 700.00 W, with the stream ceiling read from P1/P3 one call at a
#: time after the cold times' 256 MB flush (1,707 GB/s; PERF.md §6 lists
#: each figure, its source and the routes this table moves).
H100 = Prices(
    tile_ns=(2.4277822000517943, 2.0126983219263503,
             2.4678515149707096, 2.2942857930854874),
    row_tile_ns=3.172890009248958,
    step_ns=2.5895083123438214,
    tile_ns_w=(2.572843099302219, 2.4643835579256113,
               3.0330567125613785, 3.0158201154153823),
    stripe_call_ns=23887.67957687378,
    stripe_x_ns_per_byte=0.0005858711102178335,
    spill_ns=97.96659406979198,
    vals_ns=0.0,
    df_dense_mult=1.4630823984761925,
    df_slot_mult=1.941688537528436,
    df16_dense_mult=1.2173948326535842,
    tile_ns_df16=(3.357867935245943, 4.2854873738051,
                  3.6155607839707886, 4.048663749461184),
    x_window_ns=2.399728067452246,
    spill_ns_df=94.35317415922219,
    pair_spill_ns=97.96659406979198,
    pair_spill_ns_df=94.35317415922219,
    fold_ns=0.17941050427977556,
    hub_ns=11.024212793922887,
    cap_within_gate=True)


def table(prices: Optional[Prices]) -> Prices:
    """The table a planner function prices with: ``prices``, or
    :data:`REFERENCE` for ``None``."""
    return REFERENCE if prices is None else prices


def _tab(fig: Mapping) -> Table:
    """A by-width figure (keys ``nw`` as int or str) as a tuple."""
    return tuple(float(fig[w] if w in fig else fig[str(w)]) for w in NWS)


def derive_prices(m: Mapping) -> Prices:
    """The price table from named figures, as ``chip_smoke.py``'s
    ``prices`` phase measures them (``bench/probes.py``):

    * ``launch_ns``: one launch in a chain of dependent launches (P6),
      read from the eager chain of ``probes.tiny`` calls
      (``tiny_pallas_ms``): each stripe of a striped plan is one eager
      ``sell_spmv`` call (``sell8d.stripe_overhead_ns``), which pays the
      Python wrapper and its ctypes launch, so the eager figure is what a
      stripe costs today.  ``tiny`` itself launches with programmatic
      dependent launch (PDL) and a SELL kernel without it; the host binds
      the eager chain either way, so the two pay the same Python call.
      Once a bound closure no longer pays a Python call a launch (ROADMAP
      item 10), ``launch_ns`` moves to the card's floor without PDL,
      ``tiny_chain_ms``, the launch a SELL kernel makes; to
      ``tiny_chain_pdl_ms`` only if the SELL kernels gain the wait and
      launch with the attribute;
    * ``stream_gbs``: the tile-stream ceiling, GB/s (P1/P3);
    * ``step_solve``: ``{"g8": {"ms", "steps", "tiles"}, "g16": {...}}``,
      one light matrix through the slot kernel at g = 8 and 16;
      ``ms·1e6 = steps·step_ns + tiles·t`` solved for ``step_ns``
      (``baselines/probe_webbase_r4e.py``'s two-point solve), at least 0;
    * ``slot_ns``, ``slot_w_ns``, ``slot_df16_ns``: ns a tile by bundle
      width of the slot kernel (f32 values x resident, past 2M columns,
      df16);
    * ``slot_df_ns``: ns a df tile at nw = 8; ``row_ns``, ``row_df_ns``,
      ``row_df16_ns``: ns a row-mode tile in f32, df and df16;
    * ``vals_ns``: a bf16 slot tile over the same tile with palette
      values, at least 0;
    * ``rest_ns``, ``rest_ns_df``: the straggler stream a nonzero;
    * the depth cap stays within the spill gate (``cap_within_gate``);
    * ``hub_ns``, ``fold_ns``: the hub gather a column, the fold
      scatter-add a row.
    """
    s8, s16 = m["step_solve"]["g8"], m["step_solve"]["g16"]
    det = s8["steps"] * s16["tiles"] - s16["steps"] * s8["tiles"]
    step = ((s8["ms"] * s16["tiles"] - s16["ms"] * s8["tiles"]) * 1e6 / det
            if det else 0.0)
    slot = _tab(m["slot_ns"])
    row = float(m["row_ns"])
    gbs = float(m["stream_gbs"])
    return Prices(
        tile_ns=slot, row_tile_ns=row, step_ns=max(step, 0.0),
        tile_ns_w=_tab(m["slot_w_ns"]),
        stripe_call_ns=float(m["launch_ns"]),
        stripe_x_ns_per_byte=1.0 / gbs, spill_ns=float(m["rest_ns"]),
        vals_ns=max(float(m["vals_ns"]), 0.0),
        df_dense_mult=float(m["row_df_ns"]) / row,
        df_slot_mult=float(m["slot_df_ns"]) / slot[-1],
        df16_dense_mult=float(m["row_df16_ns"]) / row,
        tile_ns_df16=_tab(m["slot_df16_ns"]), x_window_ns=4096.0 / gbs,
        spill_ns_df=float(m["rest_ns_df"]),
        pair_spill_ns=float(m["rest_ns"]),
        pair_spill_ns_df=float(m["rest_ns_df"]),
        fold_ns=float(m["fold_ns"]), hub_ns=float(m["hub_ns"]),
        cap_within_gate=True)
