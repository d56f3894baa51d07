"""The planner's price table (``spmv_tpu_torch/formats/prices.py``):
``REFERENCE`` against the JAX package's constants, ``derive_prices`` on
synthetic figures, ``prices=`` reaching every cost the router computes, and
``prices=H100`` planning and computing on the CPU within ``spmv_golden``'s
bounds (f32 1e-5, f64 1e-10 of (|A||x|)_i)."""

import dataclasses

import numpy as np
import pytest
import torch

import spmv_tpu.formats.graph as j_graph
import spmv_tpu.formats.sell8d as j_8d
import spmv_tpu_torch as st
from spmv_tpu_torch import handle as th
from spmv_tpu_torch.formats import prices as pm
from spmv_tpu_torch.formats import sell8d as t_8d
from spmv_tpu_torch.io import generate as t_gen
from spmv_tpu_torch.parallel import (build_dist_auto, dist_auto_spmv,
                                     make_mesh_1d)
from spmv_tpu_torch.types import CsrMatrix

R = pm.REFERENCE

#: Prices field → the JAX package's constant (a dict by nw, or a number)
JAX_CONSTANTS = {
    "tile_ns": j_8d._TILE_NS, "row_tile_ns": j_8d._TILE_NS[1],
    "step_ns": j_8d._STEP_NS,
    "tile_ns_w": j_8d._TILE_NS_W, "stripe_call_ns": j_8d._STRIPE_CALL_NS,
    "spill_ns": j_8d._SPILL_NS, "vals_ns": j_8d._VALS_NS,
    "df_dense_mult": j_8d._DF_DENSE_MULT, "df_slot_mult": j_8d._DF_SLOT_MULT,
    "df16_dense_mult": j_8d._DF16_DENSE_MULT,
    "tile_ns_df16": j_8d._TILE_NS_DF16, "spill_ns_df": j_8d._SPILL_NS_DF,
    "pair_spill_ns": j_8d._PAIR_SPILL_NS,
    "pair_spill_ns_df": j_8d._PAIR_SPILL_NS_DF,
    "fold_ns": j_graph._FOLD_NS, "hub_ns": j_graph._HUB_NS}


@pytest.mark.parametrize("field", sorted(JAX_CONSTANTS))
def test_reference_equals_the_jax_constants(field):
    got = getattr(R, field)
    want = JAX_CONSTANTS[field]
    if isinstance(want, dict):
        assert pm.Prices.by_nw(got) == want
    else:
        assert got == want


def test_reference_literals_in_the_jax_formulas():
    # the two constants the JAX package writes inline: stripe_overhead_ns'
    # 0.027 ns a byte of x and the windowed df16 table's 27 ns a window
    assert (R.stripe_x_ns_per_byte, R.x_window_ns) == (0.027, 27.0)
    for n in (2_000_001, 4_000_000, 128_000_000):
        assert (t_8d.stripe_overhead_ns(n, R) == j_8d.stripe_overhead_ns(n)
                == t_8d.stripe_overhead_ns(n))
    assert t_8d.cost_tables(True, True, R) == j_8d.cost_tables(True, True)
    assert t_8d.dense_tile_ns("df", R) == j_8d.dense_tile_ns("df")
    # the JAX planner's depth cap is the cheapest outright
    assert R.cap_within_gate is False
    assert {f.name for f in dataclasses.fields(pm.Prices)} == \
        set(JAX_CONSTANTS) | {"stripe_x_ns_per_byte", "x_window_ns",
                              "cap_within_gate"}


def _figures(p, g8=(3932, 31456), g16=(2061, 32976), tile=14.0):
    """The figures derive_prices reads, made from table ``p`` (and a
    two-point system with ``p.step_ns`` and ``tile`` ns a tile)."""
    def ms(steps, tiles):
        return (steps * p.step_ns + tiles * tile) / 1e6
    gbs = 1.0 / p.stripe_x_ns_per_byte
    row = p.row_tile_ns
    return {
        "launch_ns": p.stripe_call_ns, "stream_gbs": gbs,
        "vals_ns": p.vals_ns,
        "step_solve": {"g8": {"ms": ms(*g8), "steps": g8[0], "tiles": g8[1]},
                       "g16": {"ms": ms(*g16), "steps": g16[0],
                               "tiles": g16[1]}},
        "slot_ns": dict(zip(pm.NWS, p.tile_ns)),
        "slot_df16_ns": {str(w): v for w, v in zip(pm.NWS, p.tile_ns_df16)},
        "slot_df_ns": p.tile_ns[-1] * p.df_slot_mult,
        "slot_w_ns": dict(zip(pm.NWS, p.tile_ns_w)),
        "row_ns": row, "row_df_ns": row * p.df_dense_mult,
        "row_df16_ns": row * p.df16_dense_mult,
        "rest_ns": p.spill_ns, "rest_ns_df": p.spill_ns_df,
        "hub_ns": p.hub_ns, "fold_ns": p.fold_ns}


def test_derive_prices_from_synthetic_figures():
    # the two-point solve of probe_webbase_r4e (its step and tile counts):
    # 75 ns a step, 14 a tile, back from the two times
    want = dataclasses.replace(R, x_window_ns=4096 * 0.027,
                               pair_spill_ns=R.spill_ns,
                               pair_spill_ns_df=R.spill_ns_df,
                               row_tile_ns=17.0, cap_within_gate=True)
    got = pm.derive_prices(_figures(want))
    for f in dataclasses.fields(pm.Prices):
        assert np.allclose(getattr(got, f.name), getattr(want, f.name),
                           rtol=1e-12), f.name
    assert abs(got.step_ns - 75.0) < 1e-9


def test_derive_prices_clamps_negative_step_and_value_prices():
    p = dataclasses.replace(R, step_ns=-5.0, vals_ns=-1.0)
    got = pm.derive_prices(_figures(p))
    assert got.step_ns == 0.0 and got.vals_ns == 0.0
    # a degenerate system (the same steps and tiles twice) gives no step
    assert pm.derive_prices(_figures(R, g16=(3932, 31456))).step_ns == 0.0


def test_table_accessor_and_hashable():
    assert pm.table(None) is R and pm.table(pm.H100) is pm.H100
    assert {R: 1}[pm.REFERENCE] == 1
    assert t_8d.cost_tables(False, False) == t_8d.cost_tables(False, False,
                                                             R)


def _scaled(p, k):
    """Every time of ``p`` times k (the multipliers unchanged): each cost
    comparison the planner makes is invariant under it."""
    out = {}
    for f in dataclasses.fields(pm.Prices):
        v = getattr(p, f.name)
        if f.name.endswith("_mult") or isinstance(v, bool):
            out[f.name] = v
        elif isinstance(v, tuple):
            out[f.name] = tuple(u * k for u in v)
        else:
            out[f.name] = v * k
    return pm.Prices(**out)


def _same_plan(p, q):
    assert type(p) is type(q)
    if isinstance(p, dict):
        assert p.keys() == q.keys()
        for k in p:
            _same_plan(p[k], q[k])
    elif isinstance(p, (list, tuple)):
        assert len(p) == len(q)
        for u, v in zip(p, q):
            _same_plan(u, v)
    elif isinstance(p, torch.Tensor):
        assert torch.equal(p, q)
    elif dataclasses.is_dataclass(p):
        for f in dataclasses.fields(p):
            if f.compare:
                _same_plan(getattr(p, f.name), getattr(q, f.name))
    elif isinstance(p, np.ndarray):
        assert np.array_equal(p, q)
    else:
        assert p == q


def _zoo():
    pl = t_gen.power_law(6000, 6000, 120_000, dtype=np.float32, seed=2)
    un = t_gen.random_uniform(5000, 5000, 24, dtype=np.float32, seed=42)
    wb = t_gen.webbase_like(20000, 20000, 60000, dtype=np.float32, seed=11,
                            spread=256)
    wide = t_gen.random_uniform(4096, 2_500_000, 64, dtype=np.float32,
                                seed=4)
    f64 = CsrMatrix(pl.m, pl.n, pl.rowptr, pl.colidx,
                    np.random.default_rng(7).standard_normal(pl.nnz))
    return {"powerlaw": pl, "uniform": un, "webbase": wb, "wide": wide,
            "powerlaw_f64": f64}


@pytest.fixture(scope="module")
def zoo():
    return _zoo()


@pytest.mark.parametrize("name", ["powerlaw", "uniform", "webbase", "wide",
                                  "powerlaw_f64"])
def test_none_is_reference_and_scaling_keeps_routes(zoo, name):
    # prices=None, REFERENCE and REFERENCE with every time doubled plan the
    # same streams bit for bit
    a = zoo[name]
    plans = [st.create_handle(a, device="cpu", prices=p).plan
             for p in (None, R, _scaled(R, 2.0))]
    _same_plan(plans[0], plans[1])
    _same_plan(plans[0], plans[2])


def test_prices_reach_the_step_and_stripe_costs(zoo):
    # g follows step_ns; the striped gate follows stripe_call_ns
    a = t_gen.random_uniform(20000, 20000, 32, dtype=np.float32, seed=42)
    g = {}
    for step in (0.0, 1e6):
        h = st.create_handle(a, device="cpu",
                             prices=dataclasses.replace(R, step_ns=step))
        g[step] = h.plan["sell8d"].g
    assert (g[0.0], g[1e6]) == (8, 32)
    kinds = [th.plan_kind(st.create_handle(
        zoo["wide"], device="cpu",
        prices=dataclasses.replace(R, stripe_call_ns=c)).plan)
        for c in (0.0, 1e12)]
    assert kinds[0] == "sell8d-striped[2]" and kinds[1] != kinds[0], kinds


@pytest.mark.parametrize("name", ["powerlaw", "uniform", "webbase", "wide",
                                  "powerlaw_f64"])
def test_h100_table_plans_and_computes_on_the_cpu(zoo, name):
    a = zoo[name]
    h = st.create_handle(a, device="cpu", prices=pm.H100)
    assert h._prices is pm.H100
    x = np.random.default_rng(0).standard_normal(a.n)
    f64 = a.vals.dtype == np.float64
    xt = torch.from_numpy(x if f64 else x.astype(np.float32))
    y = st.spmv(h, xt).double().numpy()
    g = st.spmv_golden(a.astype(np.float64), x.astype(a.vals.dtype)
                       .astype(np.float64))
    absref = st.spmv_golden(CsrMatrix(a.m, a.n, a.rowptr, a.colidx,
                                      np.abs(a.vals).astype(np.float64)),
                            np.abs(x))
    bound = 1e-10 if f64 else 1e-5
    assert np.all(np.abs(y - g) <= bound * absref + 1e-300)
    # the table survives a clear and re-prepare
    h.clear()
    h.prepare()
    _same_plan(h.plan, st.create_handle(a, device="cpu",
                                        prices=pm.H100).plan)


def test_h100_table_in_build_dist_auto_and_tune(zoo):
    a = zoo["powerlaw"]
    x = np.random.default_rng(1).standard_normal(a.n).astype(np.float32)
    g = st.spmv_golden(a.astype(np.float64), x.astype(np.float64))
    absref = st.spmv_golden(CsrMatrix(a.m, a.n, a.rowptr, a.colidx,
                                      np.abs(a.vals).astype(np.float64)),
                            np.abs(x).astype(np.float64))
    mesh = make_mesh_1d(4, device="cpu")
    for p in (None, pm.H100):
        plan = build_dist_auto(a, mesh, prices=p)
        y = dist_auto_spmv(plan, torch.from_numpy(x)).double().numpy()
        atol = 2e-4 * (a.nnz / 150_000) ** 0.5 if plan.kind == "scan" else 0
        assert np.all(np.abs(y - g) <= 1e-5 * absref + atol + 1e-300)
    h, res = st.tune(a, methods=[st.Method.SELL_C_SIGMA], iters=1,
                     repeats=1, device="cpu", prices=pm.H100)
    assert h._prices is pm.H100 and np.isfinite(list(res.values())[0])


#: A table derived on an NVIDIA H100 with the straggler priced on a long
#: stream (0.31 ns a nonzero, an eighth of a slot tile), the row-mode tile
#: read as the slot tile at nw = 1: under the JAX planner's depth cap every
#: SELL route of a power-law matrix spills past its 2% gate.
CHEAP_STRAGGLERS = pm.Prices(
    tile_ns=(2.4086247910471523, 2.0003402415586975, 2.5161926003429,
             2.252755078430079),
    row_tile_ns=2.4086247910471523, step_ns=1.555389778844431,
    tile_ns_w=(2.498274692805835, 2.404109617053394, 2.999234309832458,
               2.95921624874688),
    stripe_call_ns=13155.839443206787,
    stripe_x_ns_per_byte=0.0008816281179835757,
    spill_ns=0.30801558678170704, vals_ns=5.723809709354324,
    df_dense_mult=2.0965306969379123, df_slot_mult=1.9745680234510288,
    df16_dense_mult=1.750236072803622,
    tile_ns_df16=(3.3629426540679392, 4.294217731001155, 3.569589348106776,
                  4.0073495333338105),
    x_window_ns=3.611148771260726, spill_ns_df=0.298781619966635,
    pair_spill_ns=0.30801558678170704, pair_spill_ns_df=0.298781619966635,
    fold_ns=0.11151468103018607, hub_ns=6.396125902852481,
    cap_within_gate=True)


def test_cost_cap_budget():
    # five groups of 1..5 nonzeros, one pair each: a free straggler makes
    # cap 1 cheapest (tail 10); a budget of 4 moves it to the cheapest cap
    # whose tail fits (cap 3, tail 3); a budget nothing fits is ignored
    sizes = np.arange(1, 6, dtype=np.int64)
    assert t_8d._cost_cap(sizes, sizes, 1.0, 0.0) == 1
    assert t_8d._cost_cap(sizes, sizes, 1.0, 0.0, budget=4) == 3
    assert t_8d._cost_cap(sizes, sizes, 1.0, 0.0, budget=-1) == 1
    assert t_8d._cost_cap(sizes, sizes, 1.0, 1e9, budget=4) == 5


@pytest.fixture(scope="module")
def powerlaw40k():
    return t_gen.power_law(40_000, 40_000, 40 * 40_000, dtype=np.float32,
                           seed=2)


def test_cheap_stragglers_keep_a_sell_route(powerlaw40k):
    # the JAX planner's cap (cap_within_gate=False) spills the hybrid's
    # slot part past its gate, the row-mode pack past its pad gate, and
    # AUTO falls to the tiled scan; within the gate the hybrid holds, and
    # its y meets spmv_golden's f32 bound
    a = powerlaw40k
    jax_rule = dataclasses.replace(CHEAP_STRAGGLERS, cap_within_gate=False)
    assert th.plan_kind(st.create_handle(a, device="cpu",
                                         prices=jax_rule).plan) == "scan"
    h = st.create_handle(a, device="cpu", prices=CHEAP_STRAGGLERS)
    assert th.plan_kind(h.plan) == "hybrid(8w+8d)"
    x = np.random.default_rng(0).standard_normal(a.n).astype(np.float32)
    y = st.spmv(h, torch.from_numpy(x)).double().numpy()
    g = st.spmv_golden(a.astype(np.float64), x.astype(np.float64))
    absref = st.spmv_golden(CsrMatrix(a.m, a.n, a.rowptr, a.colidx,
                                      np.abs(a.vals).astype(np.float64)),
                            np.abs(x).astype(np.float64))
    assert np.all(np.abs(y - g) <= 1e-5 * absref + 1e-300)


@pytest.mark.parametrize("nw", [1, 8])
def test_cap_within_gate_native_and_numpy_agree(powerlaw40k, monkeypatch,
                                                nw):
    # the native stats pass takes the budget as the numpy path does: the
    # same (tiles, cap, spill).  At nw = 1 a cap fits the 2% gate; at
    # nw = 8 groups deeper than the largest cap spill past it at any cap,
    # and the budget is ignored
    a = powerlaw40k
    nat = t_8d.estimate_sell8d_auto(a, nw=nw, prices=CHEAP_STRAGGLERS)
    import spmv_tpu_torch.native as native
    monkeypatch.setattr(native, "sell8d_stats_native",
                        lambda *args, **kw: None)
    b = CsrMatrix(a.m, a.n, a.rowptr, a.colidx, a.vals)   # a fresh memo
    assert t_8d.estimate_sell8d_auto(b, nw=nw,
                                     prices=CHEAP_STRAGGLERS) == nat
    assert (nat[2] <= 0.02 * a.nnz) == (nw == 1)
    if nw == 1:
        # the native pack takes it too: the same nonzeros kept (the two
        # packers place them apart)
        packs = [t_8d.pack_sell8d(a, nw=nw, max_pad_ratio=float("inf"),
                                  prices=CHEAP_STRAGGLERS, use_native=u)
                 for u in (True, False)]
        assert packs[0][0].nnz_stored == packs[1][0].nnz_stored
        assert len(packs[0][1][0]) == len(packs[1][1][0]) <= 0.02 * a.nnz
