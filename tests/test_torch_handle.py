"""The port's main path end to end on device="cpu": create_handle + spmv
against the JAX package's own plan for the same matrix (built as it is
built on a TPU, run in interpret mode, and carried across with
plan_from_reference) and against the golden product; plan parity, past
2M columns too (column stripes, the windowed slot stream, sell8w_v2w and
the hybrid over them); the handle lifecycle; what is not ported yet; and
that the port imports no JAX.

Tolerance per row against (|A||x|)_i:
- f32: 1e-5 — the f32 sums are taken in another order;
- f64: 1e-10 against the golden product (df16 values carry ≤ 2^-39
  relative error; an f32 computation, about 1e-7, fails it), and 2e-6
  against the JAX plan run in interpret mode, where XLA:CPU simplifies the
  double-float kernels' error-free transforms to about f32 accuracy (the
  bound of tests/test_sell8w_f64.py).
"""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import spmv_tpu.handle as jh
from spmv_tpu.io import generate as j_gen
from spmv_tpu.ops.pallas_coo2 import build_coo2_fn
from spmv_tpu.ops.pallas_dia import build_dia_fn_from_parts
from spmv_tpu.ops.pallas_sell import (build_sell8d_fn, build_sell8w_v2_fn,
                                      build_sell8w_v2w_fn)
from spmv_tpu.types import Method as JMethod
import spmv_tpu_torch as st
from spmv_tpu_torch import handle as th
from spmv_tpu_torch.convert import plan_from_reference
from spmv_tpu_torch.io import generate as t_gen
from spmv_tpu_torch.ops import sell as tsell
from spmv_tpu_torch.ops.sell import V2_MAX_N

#: name → (generator call, the plan AUTO must pick, its value mode)
MATRICES = {
    "banded": (lambda g: g.banded(40000, 40000, 4, dtype=np.float32,
                                  seed=7), "dia", None),
    "uniform": (lambda g: g.random_uniform(8000, 80000, 12,
                                           dtype=np.float32, seed=42),
                "sell8d", "bf16"),
    "powerlaw": (lambda g: g.power_law(20000, 20000, 800_000,
                                       dtype=np.float32, seed=2),
                 "hybrid(8w+8d)", "palette"),
    "megarows": (lambda g: g.power_law(10000, 10000, 1_000_000, alpha=1.5,
                                       dtype=np.float32, seed=3),
                 "sell8w_v2", "palette"),
    "weblike": (lambda g: g.webbase_like(30000, 30000, 90000,
                                         dtype=np.float32, seed=11),
                "hybrid(8w+8d)", "bf16"),
    "tiny": (lambda g: g.random_uniform(300, 300, 5, dtype=np.float32,
                                        seed=1), "serial", None),
    # moderate column scatter: AUTO resolves to Method.CSR5, the two-pass
    # COO2 plan (474 pass-1 tiles, R over 485,376 product positions)
    "clustered_csr5": (lambda g: g.clustered(20_000, 20_000, 24,
                                             spread=2048, dtype=np.float32,
                                             seed=9), "coo2", None),
    # f64: the same patterns with f64 values, as bench.py's _to_f64 makes
    # them; the powerlaw one folds by x-extension (fold_planes_ext)
    "banded_f64": (lambda g: _to_f64(g.banded(40000, 40000, 4,
                                              dtype=np.float32, seed=7)),
                   "dia", None),
    "uniform_f64": (lambda g: _to_f64(g.random_uniform(
        8000, 80000, 12, dtype=np.float32, seed=42)), "sell8d", "df16"),
    "powerlaw_f64": (lambda g: _to_f64(g.power_law(
        10000, 10000, 400_000, dtype=np.float32, seed=2)),
        "hybrid(8w+8d)", "df16"),
    "tiny_f64": (lambda g: _to_f64(g.random_uniform(
        300, 300, 5, dtype=np.float32, seed=1)), "serial", None),
}

#: name → (generator call, the plan Method.CSR5 must build, its value mode)
CSR5_MATRICES = {
    "clustered": (MATRICES["clustered_csr5"][0], "coo2", None),
    # the pass-2 gate refuses: the SELL-8D retry
    "uniform": (MATRICES["uniform"][0], "sell8d", "bf16"),
    # heavy-tailed scatter: the hybrid retry
    "powerlaw": (MATRICES["powerlaw"][0], "hybrid(8w+8d)", "palette"),
    # f64 never packs COO2: the SELL-8D df retry
    "clustered_f64": (lambda g: _to_f64(MATRICES["clustered_csr5"][0](g)),
                      "sell8d", "df16"),
}


def _local(g, seed=3):
    """4096 rows of 8 nonzeros over the first 16 windows of 2.5M columns:
    few tiles, so one windowed slot stream beats two stripes' overhead."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(4096), 8)
    cols = rng.integers(0, 16384, rows.size)
    return g.CsrMatrix.from_coo(4096, 2_500_000, rows, cols,
                                rng.standard_normal(rows.size)
                                .astype(np.float32))


def _blocks(g, seed=3):
    """4096 rows of 8 nonzeros; each 128-row slice's in one window of its
    own, the windows spread over 2.5M columns: row mode (8W) packs it at
    pad 2, slot mode (8D) at 8 a slice."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(4096), 8)
    cols = (rows // 128) * 76 * 1024 + rng.integers(0, 1024, rows.size)
    return g.CsrMatrix.from_coo(4096, 2_500_000, rows, cols,
                                rng.standard_normal(rows.size)
                                .astype(np.float32))


def _heavy_light(g, nh, dh, hw, dl, width, seed=3):
    """``nh`` heavy rows of ``dh`` nonzeros within ``hw`` columns of a
    window of their 128-row slice (spread over 2.5M columns), then light
    rows of ``dl`` nonzeros over the first ``width`` columns: the
    row-split hybrid's shape past 2M columns."""
    rng = np.random.default_rng(seed)
    rh = np.repeat(np.arange(nh), dh)
    ch = ((rh // 128) * 37 + 100) * 1024 + rng.integers(0, hw, rh.size)
    rl = np.repeat(np.arange(nh, 4096), dl)
    cl = rng.integers(0, width, rl.size)
    rows, cols = np.concatenate([rh, rl]), np.concatenate([ch, cl])
    return g.CsrMatrix.from_coo(4096, 2_500_000, rows, cols,
                                rng.standard_normal(rows.size)
                                .astype(np.float32))


#: n > 2M, past the TPU's VMEM-resident x: name → (generator call, method,
#: the plan it must build, its value mode, the kernels its streams name).
#: m = 4096 over n = 2.5M.
LARGE_N = {
    # uniform scatter: the cost gate picks two column stripes, each a
    # resident stream (K1, K2)
    "uniform_striped": (lambda g: g.random_uniform(
        4096, 2_500_000, 64, dtype=np.float32, seed=4), st.Method.AUTO,
        "sell8d-striped[2]", "bf16", {"sell_slot"}),
    "uniform_striped_f64": (lambda g: _to_f64(g.random_uniform(
        4096, 2_500_000, 64, dtype=np.float32, seed=4)), st.Method.AUTO,
        "sell8d-striped[2]", "df16", {"sell_slot_df"}),
    # few tiles: one windowed slot stream (K6, K7 slot)
    "local_windowed": (_local, st.Method.SELL_C_SIGMA, "sell8d+rest", "f32",
                       {"sell_slot_w"}),
    "local_windowed_f64": (lambda g: _to_f64(_local(g)),
                           st.Method.SELL_C_SIGMA, "sell8d", "df16",
                           {"sell_slot_df_w"}),
    # row mode past 2M columns: sell8w_v2w (K5 values, K7 row)
    "blocks_v2w": (_blocks, st.Method.SELL_C_SIGMA, "sell8w_v2w", "f32",
                   {"sell_row_w"}),
    "blocks_v2w_f64": (lambda g: _to_f64(_blocks(g)),
                       st.Method.SELL_C_SIGMA, "sell8w_v2w", "df16",
                       {"sell_row_df_w"}),
    # the hybrid over sell8w_v2w and a windowed slot stream; its f64 form
    # folds by the scatter-add, not by x-extension
    "hybrid": (lambda g: _heavy_light(g, 512, 128, 1024, 6, 32768),
               st.Method.SELL_C_SIGMA, "hybrid(8w+8d)", "f32",
               {"sell_row_w", "sell_slot_w"}),
    "hybrid_f64": (lambda g: _to_f64(_heavy_light(g, 128, 1024, 2048, 6,
                                                  65536)),
                   st.Method.SELL_C_SIGMA, "hybrid(8w+8d)", "df16",
                   {"sell_row_df_w", "sell_slot_df_w"}),
}


def _to_f64(a, seed=7):
    """``a``'s pattern with standard-normal f64 values (bench.py)."""
    vals = np.random.default_rng(seed).standard_normal(a.nnz)
    return type(a)(a.m, a.n, a.rowptr, a.colidx, vals)


def _tol(a):
    """(tolerance against the golden product, against interpret mode)."""
    return (1e-10, 2e-6) if a.vals.dtype == np.float64 else (1e-5, 1e-5)


def _abs_ax(a, x):
    """(|A||x|)_i from the golden product."""
    aa = st.CsrMatrix(a.m, a.n, a.rowptr, a.colidx, np.abs(a.vals))
    return st.spmv_golden(aa.astype(np.float64),
                          np.abs(x).astype(np.float64)) + 1e-300


def _bound(a, x):
    """1e-5·(|A||x|)_i from the golden product."""
    return 1e-5 * _abs_ax(a, x)


@pytest.fixture
def x64():
    """f64 runs with jax_enable_x64 on (the JAX create_handle turns it on
    for the whole process); the flag is restored after each test."""
    was = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", was)


def _golden(a, x):
    return st.spmv_golden(a.astype(np.float64), x.astype(np.float64))


def _reference_plan(a, monkeypatch, method=JMethod.AUTO):
    """The JAX package's handle for ``a`` as it is built on a TPU."""
    monkeypatch.setattr(jh, "_is_tpu", lambda: True)
    return jh.create_handle(a, method=method)


def _striped_reference(stripes, x, m_rows):
    """The JAX striped executor: the resident slot kernel in interpret
    mode on each stripe's slice of x, its compact output added into the
    slices it touched."""
    out = np.zeros((-(-m_rows // 1024), 1024))
    for lo, hi, vis, pk in stripes:
        o = np.asarray(build_sell8d_fn(pk, interpret=True)(x[lo:hi]),
                       dtype=np.float64)
        np.add.at(out, np.asarray(vis), o.reshape(-1, 1024))
    return out.reshape(-1)[:m_rows]


def _reference_exec(plan, x, m_rows):
    """The JAX plan's executor with every Pallas kernel in interpret mode
    (the glue of spmv_tpu.handle._make_bound, in numpy)."""
    if "graph" in plan:
        # x extended by the hub columns, then by the heavy output (in x's
        # type), which the light plan's fold entries read
        hub = plan.get("hub_cols")
        x_ext = x if hub is None else np.concatenate([x, x[np.asarray(hub)]])
        if "heavy" in plan:
            k = plan["fold_k"]
            y_heavy = _reference_exec(plan["heavy"], x_ext, k)[:k]
            x_ext = np.concatenate([x_ext, y_heavy.astype(x.dtype)])
        return _reference_exec(plan["light"], x_ext, m_rows)
    if "hybrid" in plan:
        pd, psp = plan["hybrid"]
        if pd.get("fold_planes_ext"):
            # f64: the light plan reads the dense part's output appended
            # to x (spmv_tpu.handle._make_bound's hyb_df)
            y_dense = _reference_exec(pd, x, pd["m_rows"])
            return _reference_exec(psp, np.concatenate([x, y_dense]),
                                   m_rows)
        y = _reference_exec(psp, x, m_rows)
        np.add.at(y, np.asarray(pd["fold_rows"]),
                  _reference_exec(pd, x, pd.get("m_rows", m_rows)))
        return y
    if "dia_pallas" in plan:
        fn = build_dia_fn_from_parts(plan["dia_pallas"], interpret=True)
    elif "sell8d" in plan:
        fn = build_sell8d_fn(plan["sell8d"], interpret=True)
    elif "sell8w_v2" in plan:
        fn = build_sell8w_v2_fn(plan["sell8w_v2"], interpret=True)
    elif "sell8w_v2w" in plan:
        fn = build_sell8w_v2w_fn(plan["sell8w_v2w"], interpret=True)
    elif "sell8d_stripes" in plan:
        def fn(v):
            return _striped_reference(plan["sell8d_stripes"], v, m_rows)
    elif "coo2" in plan:
        fn = build_coo2_fn(plan["coo2"], interpret=True)
    else:
        rows = np.asarray(plan["rows"])
        y = np.zeros(m_rows)
        np.add.at(y, rows, np.asarray(plan["vals"], np.float64)
                  * x[np.asarray(plan["colidx"])])
        return y
    y = np.asarray(fn(x), dtype=np.float64)
    if "mega_sub_rows" in plan:
        y2 = y[:m_rows].copy()
        np.add.at(y2, np.asarray(plan["mega_sub_rows"]), y[m_rows:])
        y = y2
    if "rest_rows" in plan:
        np.add.at(y, np.asarray(plan["rest_rows"]),
                  np.asarray(plan["rest_vals"], np.float64)
                  * x[np.asarray(plan["rest_cols"])])
    return y


def _same_placed(p, q):
    """Two placed plans hold the same arrays."""
    assert sorted(p) == sorted(q)
    for k in p:
        _same_value(k, p[k], q[k])


def _same_value(k, u, v):
    """Two values of a placed plan's key ``k`` are the same."""
    if isinstance(u, (list, tuple)):        # hybrid parts, stripes
        assert type(u) is type(v) and len(u) == len(v), k
        for a, b in zip(u, v):
            _same_value(k, a, b)
    elif isinstance(u, dict):
        _same_placed(u, v)
    elif isinstance(u, torch.Tensor) and k == "data" \
            and u.dtype == torch.float64:
        # an f64 DIA plan: the port keeps the pack's f64 diagonals, the
        # JAX plan hi + lo f32 planes, which hold 48 of the 53 bits
        assert v.dtype == u.dtype and u.shape == v.shape
        assert bool(((u - v).abs() <= 2.0 ** -48 * u.abs()).all())
    elif isinstance(u, torch.Tensor):
        assert u.dtype == v.dtype and torch.equal(u, v), k
    elif hasattr(u, "__dataclass_fields__"):      # SellStream, DiaPlan
        _same_placed(vars(u), vars(v))
    elif k not in ("pad_ratio", "rest_frac", "dense_frac", "fill"):
        assert u == v, k


def _check_against_reference(name, make, kind, value_mode, method,
                             monkeypatch):
    """``create_handle(a, method)`` on the CPU: its plan and output against
    the JAX planner's (TPU gate on) and against the golden product."""
    a, ja = make(t_gen), make(j_gen)
    x = np.random.default_rng(0).standard_normal(a.n).astype(a.vals.dtype)
    h = st.create_handle(a, method=method, device="cpu")
    assert th.plan_kind(h.plan) == kind
    assert h.plan.get("value_mode") == value_mode
    if name == "powerlaw_f64":
        assert h.plan["hybrid"][0].get("fold_planes_ext")
    y = st.spmv(h, torch.from_numpy(x))
    assert y.dtype == torch.from_numpy(x).dtype and y.shape == (a.m,)
    y = y.numpy()
    tol, tol_ref = _tol(a)
    absax = _abs_ax(a, x)
    np.testing.assert_array_less(np.abs(y - _golden(a, x)), tol * absax)

    jhandle = _reference_plan(ja, monkeypatch, JMethod(int(method)))
    assert int(jhandle.method) == int(h.method)
    assert jhandle.plan.get("value_mode") == value_mode
    placed = plan_from_reference(jhandle.plan, "cpu")
    _same_placed(h.plan, placed)
    y_ref = _reference_exec(jhandle.plan, x, a.m)
    if name == "powerlaw_f64":
        # the light part's input (x extended by the dense part's compact
        # heavy rows) against the JAX dense part; a compact row's dense
        # part is a subset of its row, so (|A||x|)_i bounds it
        x_ext = th.light_part_input(h, torch.from_numpy(x)).numpy()
        pd = jhandle.plan["hybrid"][0]
        assert x_ext.shape == (h.plan["hybrid"][1]["sell8d"].n,)
        assert np.array_equal(x_ext[:a.n], x)
        np.testing.assert_array_less(
            np.abs(x_ext[a.n:] - _reference_exec(pd, x, pd["m_rows"])),
            tol_ref * absax[np.asarray(pd["fold_rows"])])
    y_car = th._make_bound(h.method, placed, a.m)(torch.from_numpy(x))
    np.testing.assert_array_less(np.abs(y_car.numpy() - y), tol * absax)
    np.testing.assert_array_less(np.abs(y_car.numpy() - y_ref),
                                 tol_ref * absax)
    np.testing.assert_array_less(np.abs(y - y_ref), tol_ref * absax)
    return h


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_main_path_matches_reference_plan(name, monkeypatch, x64):
    make, kind, value_mode = MATRICES[name]
    h = _check_against_reference(name, make, kind, value_mode,
                                 st.Method.AUTO, monkeypatch)
    if kind == "coo2":
        assert h.method == st.Method.CSR5
        c = h.plan["coo2"]
        assert c.reduce.n == 474 * 1024 and c.ntiles == 480   # 30 groups


@pytest.mark.parametrize("name", sorted(CSR5_MATRICES))
def test_csr5_matches_reference_plan(name, monkeypatch, x64):
    make, kind, value_mode = CSR5_MATRICES[name]
    h = _check_against_reference(name, make, kind, value_mode,
                                 st.Method.CSR5, monkeypatch)
    assert h.method == st.Method.CSR5


def _streams(plan):
    """The SELL streams of a placed plan."""
    if "hybrid" in plan:
        return [s for p in plan["hybrid"] for s in _streams(p)]
    if "sell8d_stripes" in plan:
        return [part[3] for part in plan["sell8d_stripes"]]
    return [plan[k] for k in ("sell8d", "sell8w_v2", "sell8w_v2w")
            if k in plan]


@pytest.mark.parametrize("name", sorted(LARGE_N))
def test_large_n_matches_reference_plan(name, monkeypatch, x64):
    make, method, kind, value_mode, kernels = LARGE_N[name]
    h = _check_against_reference(name, make, kind, value_mode, method,
                                 monkeypatch)
    assert h.n > V2_MAX_N
    streams = _streams(h.plan)
    assert {tsell.kernel_name(q) for q in streams} == kernels
    if "sell8d_stripes" in h.plan:
        # each stripe's stream is as wide as its stripe (≤ V2_MAX_N), its
        # output as tall as the slices it touched
        for lo, hi, vis, q in h.plan["sell8d_stripes"]:
            assert q.n == hi - lo <= V2_MAX_N
            assert q.m == q.nblocks * 1024
            assert q.nblocks == (len(vis) if vis is not None
                                 else q.nblocks)
    if kind.startswith("hybrid"):
        pd = h.plan["hybrid"][0]
        assert "fold_rows" in pd and not pd.get("fold_planes_ext")


def test_small_n_plans_do_not_reach_the_large_n_tiers(monkeypatch, x64):
    # at n ≤ 2M neither the stripe gate nor the striped packer runs, and
    # every stream names a resident kernel: the same plans as before the
    # large-n tiers, held to the JAX planner's
    from spmv_tpu_torch.formats import sell8d as t_8d

    def refuse(*_args, **_kw):
        raise AssertionError("a large-n tier was consulted at n ≤ 2M")

    monkeypatch.setattr(t_8d, "stripe_overhead_ns", refuse)
    monkeypatch.setattr(t_8d, "pack_sell8d_striped", refuse)
    for name in ("uniform", "powerlaw_f64"):
        make, kind, value_mode = MATRICES[name]
        h = st.create_handle(make(t_gen), device="cpu")
        assert th.plan_kind(h.plan) == kind
        assert h.plan.get("value_mode") == value_mode
        names = {tsell.kernel_name(q) for q in _streams(h.plan)}
        assert names and not any(k.endswith("_w") for k in names), names
        ref = _reference_plan(make(j_gen), monkeypatch).plan
        _same_placed(h.plan, plan_from_reference(ref, "cpu"))


def test_straggler_stream_matches_reference():
    # a depth cap of 2 spills every deeper (row, bundle) group to the
    # straggler stream: the compact-sum + scatter-add glue
    from spmv_tpu.formats.sell8d import pack_sell8d
    ja = j_gen.random_uniform(3000, 20000, 10, dtype=np.float32, seed=5)
    pk, rest = pack_sell8d(ja, g=8, depth_cap=2, max_pad_ratio=256.0,
                           max_spill=0.9, nw=2, cell_w=True)
    assert rest is not None and len(rest[0]) > 100
    plan = {"sell8d": pk, "rest_rows": rest[0], "rest_cols": rest[1],
            "rest_vals": rest[2]}
    x = np.random.default_rng(1).standard_normal(ja.n).astype(np.float32)
    y = th._make_bound(st.Method.SELL_C_SIGMA,
                       plan_from_reference(plan, "cpu"),
                       ja.m)(torch.from_numpy(x)).numpy()
    a = st.CsrMatrix(ja.m, ja.n, ja.rowptr, ja.colidx, ja.vals)
    bound = _bound(a, x)
    np.testing.assert_array_less(np.abs(y - _reference_exec(plan, x, a.m)),
                                 bound)
    np.testing.assert_array_less(np.abs(y - _golden(a, x)), bound)


def test_straggler_stream_matches_reference_f64(x64):
    # the f64 straggler stream: compact f64 sums, one f64 scatter-add
    from spmv_tpu.formats.sell8d import pack_sell8d
    ja = _to_f64(j_gen.random_uniform(3000, 20000, 10, dtype=np.float32,
                                      seed=5))
    pk, rest = pack_sell8d(ja, g=8, depth_cap=2, max_pad_ratio=256.0,
                           max_spill=0.9, nw=2, cell_w=True)
    assert pk.value_mode == "df16" and len(rest[0]) > 100
    assert np.asarray(rest[2]).dtype == np.float64
    plan = {"sell8d": pk, "rest_rows": rest[0], "rest_cols": rest[1],
            "rest_vals": rest[2]}
    x = np.random.default_rng(1).standard_normal(ja.n)
    y = th._make_bound(st.Method.SELL_C_SIGMA,
                       plan_from_reference(plan, "cpu"),
                       ja.m)(torch.from_numpy(x))
    assert y.dtype == torch.float64
    y = y.numpy()
    a = st.CsrMatrix(ja.m, ja.n, ja.rowptr, ja.colidx, ja.vals)
    absax = _abs_ax(a, x)
    np.testing.assert_array_less(np.abs(y - _golden(a, x)), 1e-10 * absax)
    np.testing.assert_array_less(np.abs(y - _reference_exec(plan, x, a.m)),
                                 2e-6 * absax)


@pytest.mark.parametrize("low,mode", [(-90, "df16"), (-110, "df")])
def test_df16_survives_exponent_spread(low, mode):
    # values whose exponents spread far more than 2^16 apart inside one
    # slot group: df16 scales each lo part by its own hi's exponent, so
    # the spread costs nothing; values below 2^-100 leave df16's range
    # and the pack falls back to df.  Held to row-by-row f64 sums: at a
    # 2^180 spread the golden product's running-sum differences lose the
    # small rows
    base = t_gen.random_uniform(3000, 30000, 8, dtype=np.float32, seed=6)
    rng = np.random.default_rng(6)
    v = rng.standard_normal(base.nnz) * 2.0 ** rng.uniform(low, 90,
                                                           base.nnz)
    a = st.CsrMatrix(base.m, base.n, base.rowptr, base.colidx, v)
    h = st.create_handle(a, device="cpu", warm=True)
    streams = [q for q in (h.plan.get("hybrid") or (h.plan,))
               for k, q in q.items() if k in ("sell8d", "sell8w_v2")]
    assert streams and {q.value_mode for q in streams} == {mode}
    x = rng.standard_normal(a.n)
    y = st.spmv(h, torch.from_numpy(x)).numpy()
    rows = np.repeat(np.arange(a.m), a.row_lengths)
    exact, absax = np.zeros(a.m), np.zeros(a.m)
    np.add.at(exact, rows, a.vals * x[a.colidx])
    np.add.at(absax, rows, np.abs(a.vals * x[a.colidx]))
    np.testing.assert_array_less(np.abs(y - exact), 1e-10 * absax + 1e-300)


def test_lifecycle_and_spellings():
    a = t_gen.random_uniform(500, 400, 9, dtype=np.float32, seed=1)
    x = np.random.default_rng(2).standard_normal(a.n).astype(np.float32)
    h = st.spmv_create_handle_all_in_one(a.m, a.n, a.rowptr, a.colidx,
                                         a.vals, device="cpu")
    assert h.device == torch.device("cpu")
    y0 = h(torch.from_numpy(x)).numpy()
    np.testing.assert_array_less(np.abs(y0 - _golden(a, x)), _bound(a, x))
    assert np.array_equal(st.spmv(h, x).numpy(), y0)     # numpy x too
    with pytest.raises(ValueError):
        st.spmv(h, torch.zeros(a.n + 1))
    with pytest.raises(ValueError):
        st.spmv(h, torch.zeros(a.n, device="meta"))
    st.spmv_clear_handle(h)
    with pytest.raises(RuntimeError):
        st.spmv(h, x)
    h.prepare(st.Method.SELL_C_SIGMA)
    assert h.method == st.Method.SELL_C_SIGMA
    np.testing.assert_array_less(np.abs(st.spmv(h, x).numpy()
                                        - _golden(a, x)), _bound(a, x))
    assert st.spmv_destory_handle is st.spmv_destroy_handle
    st.spmv_destory_handle(h)
    with pytest.raises(RuntimeError):
        h.prepare()


def test_not_ported_raises():
    # the one route of create_handle left: a matrix neither f32 nor f64
    # (the JAX package also takes bf16; ROADMAP item 6)
    a = t_gen.random_uniform(2000, 2000, 8, dtype=np.float32, seed=3)
    with pytest.raises(NotImplementedError, match="float16.*item 6"):
        st.create_handle(a.astype(np.float16), device="cpu")


def test_port_imports_no_jax(tmp_path):
    # spmv_tpu_torch/ alone (no spmv_tpu/ beside it, no build outputs):
    # it imports no JAX, builds its native packer from its own copy of the
    # source, and runs f32 and f64 SELL plans, a COO2 plan, packed by the
    # fused C++ pipeline, a graph plan and a Balanced scan, and the
    # execute-many layer: tune, the solvers, the CSV suite and a Matrix
    # Market round trip through the C++ parser
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.copytree(os.path.join(root, "spmv_tpu_torch"),
                    tmp_path / "spmv_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    code = (
        "import sys, numpy as np, torch\n"
        "import spmv_tpu_torch as st\n"
        "from spmv_tpu_torch import native\n"
        "from spmv_tpu_torch.handle import plan_kind\n"
        "from spmv_tpu_torch.io import generate\n"
        "assert native.native_available()\n"
        "assert native.load_native()._name.startswith(sys.argv[1])\n"
        "a = generate.random_uniform(3000, 30000, 8, dtype=np.float32,"
        " seed=6)\n"
        "for dt in (np.float32, np.float64):\n"
        "    b = a.astype(dt)\n"
        "    h = st.create_handle(b, device='cpu')\n"
        "    assert plan_kind(h.plan) == 'sell8d', plan_kind(h.plan)\n"
        "    y = st.spmv(h, torch.ones(a.n, dtype=torch.float64)).numpy()\n"
        "    assert y.dtype == dt\n"
        "    g = st.spmv_golden(b.astype(np.float64), np.ones(a.n))\n"
        "    assert np.allclose(y, g, rtol=1e-4, atol=1e-3)\n"
        "from spmv_tpu_torch.formats import coo2\n"
        "c = generate.clustered(6000, 6000, 24, spread=2048,"
        " dtype=np.float32, seed=9)\n"
        "h = st.create_handle(c, method=st.Method.CSR5, device='cpu')\n"
        "assert plan_kind(h.plan) == 'coo2', plan_kind(h.plan)\n"
        "assert coo2.packs == {'native': 1, 'native_place': 0,"
        " 'python': 0}, coo2.packs\n"
        "y = st.spmv(h, torch.ones(c.n)).numpy()\n"
        "g = st.spmv_golden(c.astype(np.float64), np.ones(c.n))\n"
        "assert np.allclose(y, g, rtol=1e-4, atol=1e-3)\n"
        "w = generate.webbase_like(20000, 20000, 60000, dtype=np.float32,"
        " seed=11, spread=256)\n"
        "for m, kind in ((st.Method.AUTO, 'graph'),"
        " (st.Method.BALANCED, 'scan')):\n"
        "    h = st.create_handle(w, method=m, device='cpu')\n"
        "    assert plan_kind(h.plan) == kind, plan_kind(h.plan)\n"
        "    y = st.spmv(h, torch.ones(w.n)).numpy()\n"
        "    g = st.spmv_golden(w.astype(np.float64), np.ones(w.n))\n"
        "    assert np.allclose(y, g, rtol=1e-4, atol=1e-3)\n"
        "from spmv_tpu_torch import solvers, tune\n"
        "from spmv_tpu_torch.bench import suite, timing\n"
        "from spmv_tpu_torch.io import mmio\n"
        "s = generate.diag_plus_random(500, nnz_per_row=4, seed=1)\n"
        "h, res = tune(s, iters=1, repeats=1, device='cpu')\n"
        "assert len(res) == 7 and h.device.type == 'cpu', res\n"
        "x, r, it = solvers.bicgstab(h, np.ones(s.n), tol=1e-8)\n"
        "assert r <= 1e-8 and it > 0 and x.device.type == 'cpu'\n"
        "import io\n"
        "rows = suite.bench_matrix('s', s, [st.Method.AUTO], iters=1,"
        " repeats=1, out=io.StringIO(), device='cpu')\n"
        "assert len(rows) == 1 and len(rows[0].split(',')) == 10, rows\n"
        "mmio.write_mtx(sys.argv[1] + '/s.mtx', s)\n"
        "t = mmio.read_mtx(sys.argv[1] + '/s.mtx')\n"
        "assert mmio.reads == {'native': 1, 'python': 0}, mmio.reads\n"
        "assert np.array_equal(t.vals, s.vals)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'ml_dtypes', 'spmv_tpu')]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_port_all_covers_jax_all():
    # every public name of the JAX package, tune and solvers among them
    import spmv_tpu
    assert set(spmv_tpu.__all__) <= set(st.__all__)
    for name in st.__all__:
        assert getattr(st, name) is not None, name
    from spmv_tpu_torch import bench, parallel, solvers
    assert st.tune is st.inspector.tune and st.solvers is solvers
    assert st.bench is bench and st.parallel is parallel
