"""The port's single-device graph plan against the JAX package's
(tests/test_graph.py): hub columns appended to x, the heavy rows on K1's
row mode, the light rows on K1's slot mode over x extended by the hubs and
by the heavy output.

Held, on the CPU:
- ``_graph_gate`` and ``_build_graph_plan`` to the JAX package's, array for
  array (f32 and f64);
- AUTO on webbase-shaped matrices (``_web()`` of test_graph.py and the
  50k-row webbase-like matrix) and ``Method.SELL_C_SIGMA``'s last resort
  to the JAX planner's plan (TPU gate on): the same tile counts, hubs,
  ``fold_k`` and straggler stream;
- the result, per row against (|A||x|)_i at 1e-5 (f32 sums in another
  order), to the golden product and to the JAX plan run with its Pallas
  kernels in interpret mode; the port's executor also runs the JAX plan
  itself (``plan_from_reference``);
- each part's input (``graph_part_inputs``) to the JAX executor's.
"""

import numpy as np
import pytest
import torch

import spmv_tpu.handle as jh
from spmv_tpu.formats.graph import prepare_graph_split as j_prepare
from spmv_tpu.io import generate as j_gen
from spmv_tpu.types import Method as JMethod
import spmv_tpu_torch as st
from spmv_tpu_torch import handle as th
from spmv_tpu_torch.convert import plan_from_reference
from spmv_tpu_torch.formats.graph import prepare_graph_split as t_prepare
from spmv_tpu_torch.io import generate as t_gen
from test_torch_handle import (_abs_ax, _golden, _reference_exec,
                               _same_placed)

#: name → generator call (either package's generate module)
GRAPHS = {
    # tests/test_graph.py's _web()
    "web20k": lambda g: g.webbase_like(20_000, 20_000, 60_000,
                                       dtype=np.float32, seed=11,
                                       spread=256),
    # the webbase-like matrix no SELL tile plan fits
    "web50k": lambda g: g.webbase_like(50_000, 50_000, 150_000,
                                       dtype=np.float32, seed=11),
}


@pytest.fixture(autouse=True)
def tpu_gate(monkeypatch):
    monkeypatch.setattr(jh, "_is_tpu", lambda: True)


def _x(a):
    return np.random.default_rng(5).standard_normal(a.n).astype(np.float32)


def _shape(plan):
    """What the two planners must agree on beyond the arrays."""
    light = plan["light"]["sell8d"]
    heavy = plan["heavy"]["sell8w_v2"] if "heavy" in plan else None
    return {"light_tiles": light.meta.shape[0],
            "heavy_tiles": None if heavy is None else heavy.meta.shape[0],
            "hubs": len(plan["hub_cols"]) if "hub_cols" in plan else 0,
            "fold_k": plan.get("fold_k", 0),
            "rest": plan["light"]["rest"]["cols"].numel()
            if "rest" in plan["light"] else 0,
            "value_mode": plan["value_mode"], "nw": light.nw}


def test_graph_gate():
    ja, ta = GRAPHS["web20k"](j_gen), GRAPHS["web20k"](t_gen)
    jp, tp = j_prepare(ja), t_prepare(ta)
    assert th._graph_gate(ta, tp) and jh._graph_gate(ja, jp)
    assert not th._graph_gate(ta, None)
    a64 = ta.astype(np.float64)
    assert not th._graph_gate(a64, t_prepare(a64))
    assert not jh._graph_gate(ja.astype(np.float64),
                              j_prepare(ja.astype(np.float64)))
    # a banded matrix has neither hubs nor heavy rows
    assert t_prepare(t_gen.banded(3000, 3000, 2, dtype=np.float32)) is None


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_build_graph_plan_matches_reference(dtype):
    ja = GRAPHS["web20k"](j_gen).astype(dtype)
    ta = GRAPHS["web20k"](t_gen).astype(dtype)
    tp, jp = t_prepare(ta), j_prepare(ja)
    assert np.array_equal(tp.hub_cols, jp.hub_cols)
    assert np.array_equal(tp.fold_rows, jp.fold_rows)
    plan = th._build_graph_plan(ta, tp)
    ref = jh._build_graph_plan(ja, jp)
    assert sorted(plan) == sorted(ref)
    assert sorted(plan["light"]) == sorted(ref["light"])
    assert plan["fold_k"] == ref["fold_k"] == tp.heavy.m
    placed = th._place(plan, "cpu")
    _same_placed(placed, plan_from_reference(ref, "cpu"))
    # the placed plan keeps the heavy row count the light stream reads
    assert "sell8w" not in placed["heavy"]
    assert (placed["heavy"]["sell8w_v2"].n + placed["fold_k"]
            == placed["light"]["sell8d"].n == ta.n + len(tp.hub_cols)
            + tp.heavy.m)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("method", [st.Method.AUTO, st.Method.SELL_C_SIGMA])
def test_graph_plan_matches_reference(name, method):
    ta, ja = GRAPHS[name](t_gen), GRAPHS[name](j_gen)
    h = st.create_handle(ta, method=method, device="cpu")
    jhandle = jh.create_handle(ja, method=JMethod(int(method)))
    assert th.plan_kind(h.plan) == "graph" and "graph" in jhandle.plan
    assert h.method == st.Method.SELL_C_SIGMA
    assert int(jhandle.method) == int(h.method)
    placed = plan_from_reference(jhandle.plan, "cpu")
    _same_placed(h.plan, placed)
    assert _shape(h.plan) == _shape(placed)
    assert h.plan["pad_ratio"] < 48.0 and h.plan["fold_k"] > 0

    x = _x(ta)
    y = st.spmv(h, torch.from_numpy(x)).numpy()
    bound = 1e-5 * _abs_ax(ta, x)
    np.testing.assert_array_less(np.abs(y - _golden(ta, x)), bound)
    y_ref = _reference_exec(jhandle.plan, x, ta.m)
    np.testing.assert_array_less(np.abs(y - y_ref), bound)
    # the port's executor on the JAX package's own plan
    y_car = th._make_bound(h.method, placed, ta.m)(torch.from_numpy(x))
    np.testing.assert_array_less(np.abs(y_car.numpy() - y_ref), bound)


def test_graph_part_inputs():
    ta, ja = GRAPHS["web50k"](t_gen), GRAPHS["web50k"](j_gen)
    h = st.create_handle(ta, device="cpu")
    jplan = jh.create_handle(ja).plan
    x = _x(ta)
    parts = th.graph_part_inputs(h, torch.from_numpy(x))
    hub = np.asarray(jplan["hub_cols"])
    x_ext = np.concatenate([x, x[hub]])
    assert np.array_equal(parts["heavy"].numpy(), x_ext)
    assert parts["heavy"].shape == (h.plan["heavy"]["sell8w_v2"].n,)
    light = parts["light"].numpy()
    assert light.shape == (h.plan["light"]["sell8d"].n,)
    assert np.array_equal(light[:len(x_ext)], x_ext)
    # the appended block is the heavy rows' output: each heavy row is a
    # part of the row fold_rows[j] of A, so (|A||x|)_i bounds it
    k = jplan["fold_k"]
    y_heavy = _reference_exec(jplan["heavy"], x_ext, k)[:k]
    fold_rows = t_prepare(ta).fold_rows
    np.testing.assert_array_less(np.abs(light[len(x_ext):] - y_heavy),
                                 1e-5 * _abs_ax(ta, x)[fold_rows])


def test_graph_bind_checks_the_extension():
    # a heavy row count that does not fill the light stream's extension
    # would let the light kernel read past x: binding refuses it
    h = st.create_handle(GRAPHS["web20k"](t_gen), device="cpu")
    bad = {**h.plan, "fold_k": h.plan["fold_k"] - 1}
    with pytest.raises(ValueError, match="graph plan"):
        th._make_bound(h.method, bad, h.m)


def test_csr5_on_web_takes_the_tiled_scan():
    # Method.CSR5: the pass-2 gate refuses, and the SELL branch's graph
    # plan does not count as a CSR5 plan, so the tiled scan
    ta, ja = GRAPHS["web50k"](t_gen), GRAPHS["web50k"](j_gen)
    h = st.create_handle(ta, method=st.Method.CSR5, device="cpu")
    jhandle = jh.create_handle(ja, method=JMethod.CSR5)
    assert th.plan_kind(h.plan) == "scan" and h.method == st.Method.CSR5
    _same_placed(h.plan, plan_from_reference(jhandle.plan, "cpu"))
    x = _x(ta)
    y = st.spmv(h, torch.from_numpy(x)).numpy()
    g = _golden(ta, x)
    # f32 prefix sums: tests/test_methods.py's absolute term
    bound = 1e-5 * _abs_ax(ta, x) + 1e-4 * max(np.abs(g).max(), 1.0)
    np.testing.assert_array_less(np.abs(y - g), bound)
    np.testing.assert_array_less(
        np.abs(y - np.asarray(jh.spmv(jhandle, x), np.float64)), bound)
