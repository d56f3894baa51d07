"""The port's spans and launch counts (``spmv_tpu_torch/utils/profiling.py``)
on the CPU: tracing off records nothing; under ``trace`` the Chrome trace
nests each kernel's span in its product's, and each route's glue spans
appear; the solver's read spans match ``host_syncs``; ``predeal_profile``
yields the pre-deal's stages; self time never passes inclusive time; the
launch table counts and clears."""

import importlib.util
import json
import os
import time

import numpy as np
import pytest
import torch

import spmv_tpu_torch as st
from spmv_tpu_torch import solvers
from spmv_tpu_torch.bench import probes
from spmv_tpu_torch.io import generate as g
from spmv_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _local_rest(g):
    """4096 rows of 8 nonzeros over the first 16 windows of 2.5M columns:
    one windowed slot stream with stragglers (``sell8d+rest``)."""
    rng = np.random.default_rng(3)
    rows = np.repeat(np.arange(4096), 8)
    cols = rng.integers(0, 16384, rows.size)
    return g.CsrMatrix.from_coo(4096, 2_500_000, rows, cols,
                                rng.standard_normal(rows.size)
                                .astype(np.float32))


#: route → (matrix, create_handle's keywords, the plan, the glue spans a
#: product passes)
ROUTES = {
    "dia": (lambda: g.banded(4000, 4000, 4, dtype=np.float64, seed=7), {},
            "dia", set()),
    "hybrid_fold": (lambda: g.power_law(20000, 20000, 800_000,
                                        dtype=np.float32, seed=2), {},
                    "hybrid(8w+8d)", {"spmv.glue.fold"}),
    "hybrid_xext_f64": (lambda: g.power_law(10000, 10000, 400_000,
                                            dtype=np.float32, seed=2)
                        .astype(np.float64), {}, "hybrid(8w+8d)",
                        {"spmv.glue.xext"}),
    "graph": (lambda: g.webbase_like(20_000, 20_000, 60_000,
                                     dtype=np.float32, seed=11, spread=256),
              {}, "graph", {"spmv.glue.xext", "spmv.glue.rest"}),
    "rest": (lambda: _local_rest(g), {"method": st.Method.SELL_C_SIGMA},
             "sell8d+rest", {"spmv.glue.rest"}),
    "stripes": (lambda: g.random_uniform(4096, 2_500_000, 64,
                                         dtype=np.float32, seed=4), {},
                "sell8d-striped[2]", {"spmv.glue.stripes"}),
    "perm": (lambda: g.banded(4000, 4000, 4, dtype=np.float32, seed=7),
             {"reorder": "rcm"}, "dia", {"spmv.glue.perm"}),
}


@pytest.fixture(autouse=True)
def empty_table():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _handle(route):
    make, kw, kind, glue = ROUTES[route]
    h = st.create_handle(make(), device="cpu", **kw)
    assert st.handle.plan_kind(h.plan) == kind
    return h, glue


def _x(h):
    dt = torch.float64 if h.dtype == np.float64 else torch.float32
    return torch.from_numpy(np.random.default_rng(1).standard_normal(h.n)
                            ).to(dt)


def _cg_handle():
    return st.create_handle(g.banded(2000, 2000, 3, dtype=np.float64,
                                     seed=3), device="cpu")


def test_off_records_nothing(monkeypatch):
    # no profiler and no pre-deal record: a product, a bound call, a solve
    # and a handle leave the table empty and never read the clock in a span
    h = _cg_handle()
    assert not profiling.live()
    assert profiling.span("spmv.product") is profiling.span("solver.read")
    monkeypatch.setattr(profiling.time, "perf_counter",
                        lambda: pytest.fail("a span read the clock"))
    x = _x(h)
    st.spmv(h, x)
    h._bound(x)
    solvers.cg(h, x, tol=0.0, maxiter=3)
    monkeypatch.undo()
    st.create_handle(g.banded(500, 500, 2, dtype=np.float32, seed=1),
                     device="cpu")
    assert profiling.spans() == {}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_trace_nests_kernels_in_products(tmp_path, route):
    # each kernel span (and glue span) of a product lies inside that
    # product's span on the profiler's clock; spmv() and the bound closure
    # each give one product span a call; y is the untraced y
    h, glue = _handle(route)
    x = _x(h)
    want = st.spmv(h, x)
    with profiling.trace(str(tmp_path)):
        y1 = st.spmv(h, x)
        y2 = h._bound(x)
    assert torch.equal(y1, want) and torch.equal(y2, want)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ours = [e for e in events if e.get("ph") == "X"
            and e["name"].startswith("spmv.")]
    products = [e for e in ours if e["name"] == "spmv.product"]
    assert len(products) == 2
    inner = [e for e in ours if e["name"] != "spmv.product"]
    assert any(e["name"].startswith("spmv.kernel.") for e in inner)
    assert glue <= {e["name"] for e in inner}
    for e in inner:
        assert any(p["ts"] <= e["ts"] and e["ts"] + e["dur"]
                   <= p["ts"] + p["dur"] + 1e-3 for p in products), e
    table = profiling.spans()
    assert table["spmv.product"]["count"] == 2
    assert {k for k in table if k.startswith("spmv.glue.")} == glue


@pytest.mark.parametrize("maxiter", [1, 7, 50])
def test_read_spans_match_host_syncs(tmp_path, maxiter):
    h = _cg_handle()
    b = _x(h)
    before = solvers.host_syncs
    with profiling.trace(str(tmp_path)):
        solvers.cg(h, b, tol=0.0, maxiter=maxiter)
    table = profiling.spans()
    assert table["solver.read"]["count"] == solvers.host_syncs - before
    assert table["solver.solve"]["count"] == 1
    # a product a step and the first residual's
    assert table["spmv.product"]["count"] == maxiter + 1


@pytest.mark.parametrize("name,prepared", [("banded", False),
                                           ("weblike", True)])
def test_predeal_profile_stages(name, prepared):
    # AUTO refines the heavy-tailed matrix only (prepare_s > 0)
    a = (g.banded(4000, 4000, 4, dtype=np.float64, seed=7) if name ==
         "banded" else g.webbase_like(30000, 30000, 90000, dtype=np.float32,
                                      seed=11))
    t0 = time.perf_counter()
    with profiling.predeal_profile() as laps:
        st.create_handle(a, device="cpu")
        wall = time.perf_counter() - t0
        got = dict(laps)
    stages = [got[k] for k in ("inspect_s", "prepare_s", "build_s",
                               "place_s")]
    assert all(v >= 0 for v in stages)
    assert (got["prepare_s"] > 0) == prepared
    assert got["inspect_s"] > 0 and got["build_s"] > 0
    assert got["transfer_s"] <= got["place_s"]
    assert sum(stages) <= wall
    assert got["bytes"] > 0
    # the same seconds reach the span table
    table = profiling.spans()
    assert table["predeal.build"]["inclusive_s"] == got["build_s"]


def test_self_time_within_inclusive(tmp_path):
    # self time is inclusive less the live children: never above it, and
    # a product's self plus its children's inclusive is its inclusive
    h, _ = _handle("hybrid_fold")
    with profiling.trace(str(tmp_path)):
        for _ in range(3):
            st.spmv(h, _x(h))
        solvers.power_iteration(h, iters=2)
    table = profiling.spans()
    for name, s in table.items():
        assert 0 <= s["self_s"] <= s["inclusive_s"] + 1e-12, name
    kids = sum(s["inclusive_s"] for k, s in table.items()
               if k.startswith(("spmv.kernel.", "spmv.glue.")))
    p = table["spmv.product"]
    assert p["self_s"] + kids == pytest.approx(p["inclusive_s"])
    assert table["solver.solve"]["self_s"] < \
        table["solver.solve"]["inclusive_s"]


def test_nested_span_of_one_name_merges():
    # a span opened directly inside one of its name records nothing of its
    # own; one of another name between them keeps both
    with profiling.predeal_profile():
        with profiling.span("spmv.product"):
            with profiling.span("spmv.product"):
                with profiling.span("spmv.kernel.dia"):
                    with profiling.span("spmv.product"):
                        pass
    table = profiling.spans()
    assert table["spmv.product"]["count"] == 2
    assert table["spmv.kernel.dia"]["count"] == 1


def test_launch_table_counts_and_clears():
    # a launch counts one under its kernel's name (the probes' counter, on
    # the card each kernel call's); the plain versions count none; chip
    # smoke's zero_counts clears the table and read_counts copies it
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_counts", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    launches = profiling.launches
    smoke.zero_counts()
    assert not launches
    h, _ = _handle("hybrid_fold")
    st.spmv(h, _x(h))
    probes.tiny(torch.ones(8, 128))
    assert not launches
    launches["tiny"] += 1
    launches["tiny"] += 3
    launches["fma_err"] += 1
    assert dict(launches) == {"tiny": 4, "fma_err": 1}
    got = smoke.read_counts()
    assert got["tiny"] == 4 and got["fma_err"] == 1
    assert set(got) == set(smoke.KERNELS) and sum(got.values()) == 5
    got["tiny"] = 0
    assert dict(launches) == {"tiny": 4, "fma_err": 1}      # a copy
    smoke.zero_counts()
    assert not launches and smoke.read_counts()["tiny"] == 0


def test_sell_cs_span_opens_in_the_product(tmp_path):
    # the hybrid's light part in SELL-32-σ with explicit columns and its
    # heavy part in row-split CSR (a plan built for a CUDA device, bound on
    # the CPU through the handle's product closure): each kernel span opens
    # inside each product, beside the fold; the plain versions launch
    # nothing, and the launch table that chip_smoke.py reads carries the
    # kernels' names (its counted runs on the card must see launches)
    from spmv_tpu_torch import handle as th
    from spmv_tpu_torch.ops import csr_split, sell_cs
    a = g.power_law(20000, 20000, 800_000, dtype=np.float32, seed=2)
    a = g.CsrMatrix(a.m, a.n, a.rowptr, a.colidx,
                    np.random.default_rng(0).standard_normal(a.nnz)
                    .astype(np.float32))
    h = st.create_handle(a, device="cpu")
    plan = th._build_plan(a, h.method, 0, hints={"device_type": "cuda"})
    assert th.plan_kind(plan) == "hybrid(split+cs)"
    bound = th._product(th._make_bound(h.method, th._place(plan, "cpu"),
                                       a.m))
    x = _x(h)
    before = dict(profiling.launches)
    want = bound(x)
    with profiling.trace(str(tmp_path)):
        assert torch.equal(bound(x), want)
        assert torch.equal(bound(x), want)
    assert dict(profiling.launches) == before
    table = profiling.spans()
    assert table["spmv.kernel." + sell_cs.KERNEL]["count"] == 2
    assert table["spmv.kernel." + csr_split.KERNEL]["count"] == 2
    assert table["spmv.product"]["count"] == 2
    assert "spmv.kernel.sell_slot" not in table
    assert "spmv.kernel.sell_row" not in table
    assert "spmv.glue.fold" in table
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    products = [e for e in spans if e["name"] == "spmv.product"]
    kernels = [e for e in spans if e["name"] in (
        "spmv.kernel.sell_cs", "spmv.kernel.csr_split")]
    assert len(kernels) == 4
    for e in kernels:
        assert any(p["ts"] <= e["ts"] and e["ts"] + e["dur"]
                   <= p["ts"] + p["dur"] + 1e-3 for p in products), e
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_cs", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for kernel in (sell_cs.KERNEL, csr_split.KERNEL):
        assert kernel in smoke.KERNELS
        assert smoke.read_counts()[kernel] == profiling.launches[kernel]
