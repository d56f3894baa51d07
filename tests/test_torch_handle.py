"""The port's main path end to end on device="cpu": create_handle + spmv
against the JAX package's own plan for the same matrix (built as it is
built on a TPU, run in interpret mode, and carried across with
plan_from_reference) and against the golden product; plan parity; the
handle lifecycle; what is not ported yet; and that the port imports no
JAX.

Tolerance per row: |Δy| ≤ 1e-5·(|A||x|)_i — the f32 sums are taken in
another order.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import spmv_tpu.handle as jh
from spmv_tpu.io import generate as j_gen
from spmv_tpu.ops.pallas_dia import build_dia_fn_from_parts
from spmv_tpu.ops.pallas_sell import build_sell8d_fn, build_sell8w_v2_fn
from spmv_tpu.types import Method as JMethod
import spmv_tpu_torch as st
from spmv_tpu_torch import handle as th
from spmv_tpu_torch.convert import plan_from_reference
from spmv_tpu_torch.io import generate as t_gen

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
}


def _bound(a, x):
    """1e-5·(|A||x|)_i from the golden product."""
    aa = st.CsrMatrix(a.m, a.n, a.rowptr, a.colidx, np.abs(a.vals))
    return 1e-5 * st.spmv_golden(aa.astype(np.float64),
                                 np.abs(x).astype(np.float64)) + 1e-30


def _golden(a, x):
    return st.spmv_golden(a.astype(np.float64), x.astype(np.float64))


def _reference_plan(a, monkeypatch):
    """The JAX package's handle for ``a`` as it is built on a TPU."""
    monkeypatch.setattr(jh, "_is_tpu", lambda: True)
    return jh.create_handle(a, method=JMethod.AUTO)


def _reference_exec(plan, x, m_rows):
    """The JAX plan's executor with every Pallas kernel in interpret mode
    (the glue of spmv_tpu.handle._make_bound, in numpy)."""
    if "hybrid" in plan:
        pd, psp = plan["hybrid"]
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
        u, v = p[k], q[k]
        if k == "hybrid":
            for a, b in zip(u, v):
                _same_placed(a, b)
        elif isinstance(u, dict):
            _same_placed(u, v)
        elif isinstance(u, torch.Tensor):
            assert u.dtype == v.dtype and torch.equal(u, v), k
        elif hasattr(u, "__dataclass_fields__"):      # SellStream, DiaPlan
            _same_placed(vars(u), vars(v))
        elif k not in ("pad_ratio", "rest_frac", "dense_frac", "fill"):
            assert u == v, k


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_main_path_matches_reference_plan(name, monkeypatch):
    make, kind, value_mode = MATRICES[name]
    a, ja = make(t_gen), make(j_gen)
    x = np.random.default_rng(0).standard_normal(a.n).astype(np.float32)
    h = st.create_handle(a, method=st.Method.AUTO, device="cpu")
    assert th.plan_kind(h.plan) == kind
    assert h.plan.get("value_mode") == value_mode
    y = st.spmv(h, torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == (a.m,)
    y = y.numpy()
    bound = _bound(a, x)
    np.testing.assert_array_less(np.abs(y - _golden(a, x)), bound)

    jhandle = _reference_plan(ja, monkeypatch)
    assert int(jhandle.method) == int(h.method)
    placed = plan_from_reference(jhandle.plan, "cpu")
    _same_placed(h.plan, placed)
    y_ref = _reference_exec(jhandle.plan, x, a.m)
    y_car = th._make_bound(h.method, placed, a.m)(torch.from_numpy(x))
    np.testing.assert_array_less(np.abs(y_car.numpy() - y_ref), bound)
    np.testing.assert_array_less(np.abs(y - y_ref), bound)


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


def test_not_ported_raises(monkeypatch):
    a = t_gen.random_uniform(2000, 2000, 8, dtype=np.float32, seed=3)
    with pytest.raises(NotImplementedError, match="K2, K4"):
        st.create_handle(a.astype(np.float64), device="cpu")
    for m in (st.Method.BALANCED, st.Method.BALANCED2,
              st.Method.BALANCED_YID, st.Method.CSR5, st.Method.BCSR):
        with pytest.raises(NotImplementedError):
            st.create_handle(a, method=m, device="cpu")
    with pytest.raises(NotImplementedError):
        st.create_handle(a, method=st.Method.SELL_C_SIGMA, device="cpu",
                         vectorized=st.VectorizedWay.NONE)
    with pytest.raises(NotImplementedError):
        st.create_handle(a, reorder="rcm", device="cpu")
    # the graph rung: no SELL tile plan fits; the JAX package falls
    # through to its graph plan or its XLA plans, neither ported
    make = (lambda g: g.webbase_like(50000, 50000, 150_000,
                                     dtype=np.float32, seed=11))
    with pytest.raises(NotImplementedError, match="graph"):
        st.create_handle(make(t_gen), device="cpu")
    ref = _reference_plan(make(j_gen), monkeypatch).plan
    assert not {"sell8d", "sell8w_v2", "hybrid", "dia_pallas"} & set(ref)


def test_port_imports_no_jax():
    code = (
        "import sys, numpy as np, torch\n"
        "import spmv_tpu_torch as st\n"
        "from spmv_tpu_torch.io import generate\n"
        "a = generate.power_law(3000, 3000, 60000, dtype=np.float32,"
        " seed=2)\n"
        "h = st.create_handle(a, device='cpu')\n"
        "st.spmv(h, torch.ones(a.n))\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'ml_dtypes', 'spmv_tpu')]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
