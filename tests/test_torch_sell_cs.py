"""SELL-32-σ with explicit columns (``formats/sell_cs.py``, K12's plain
version in ``ops/sell_cs.py``) on the CPU: the pack holds every nonzero
once, in its row's order, rows longest first, with the padding its slice
lengths give; the plain version sums each row in slot order and agrees
with the SELL-8D plan and the f64 reference; the rule that picks the
layout through the planner (as a pure function it is
``test_torch_launch.py``'s); a plan built for a CUDA device runs on the
CPU.  The kernel itself runs on the card
(``chip_smoke.py``'s ``sell_cs`` phase)."""

import numpy as np
import pytest
import torch

import spmv_tpu_torch as st
from spmv_tpu_torch import handle as th
from spmv_tpu_torch import ops as launch_ops
from spmv_tpu_torch.formats import sell_cs as fmt
from spmv_tpu_torch.formats.sell8d import prepare_hybrid, slot_value_mode
from spmv_tpu_torch.io import generate as g
from spmv_tpu_torch.ops import sell_cs as ops
from spmv_tpu_torch.types import CsrMatrix, Method


def _revalue(a, kind, seed=0):
    """``a`` with gaussian f32 (``f32``), f64 (``f64``), bf16-exact
    (``bf16``: k / 32, k < 256) or seven-valued (``palette``) values."""
    rng = np.random.default_rng(seed)
    if kind == "bf16":
        v = (rng.integers(1, 256, a.nnz) / 32.0).astype(np.float32)
    elif kind == "palette":
        v = (rng.integers(1, 8, a.nnz) / 4.0).astype(np.float32)
    else:
        v = rng.standard_normal(a.nnz).astype(
            np.float64 if kind == "f64" else np.float32)
    return CsrMatrix(a.m, a.n, a.rowptr, a.colidx, v)


def _clustered_heavy(m=20000, seed=5):
    """8 nonzeros a row within ±64 columns, and every 40th row 300 more at
    random columns: a hybrid whose light part packs densely in SELL-8D."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), 8)
    cols = np.clip(rows + rng.integers(-64, 64, rows.size), 0, m - 1)
    hr = np.repeat(np.arange(0, m, 40), 300)
    r = np.concatenate([rows, hr])
    c = np.concatenate([cols, rng.integers(0, m, hr.size)])
    return CsrMatrix.from_coo(m, m, r, c, rng.standard_normal(r.size)
                              .astype(np.float32))


def _powerlaw(m, nnz, seed, kind="f32"):
    return _revalue(g.power_law(m, m, nnz, dtype=np.float32, seed=seed),
                    kind)


#: name → a matrix to pack whole
PACKS = {
    "powerlaw": lambda: _powerlaw(5000, 100_000, 3),
    "empty_rows": lambda: _revalue(g.with_empty_rows(
        g.random_uniform(1000, 700, 6, dtype=np.float32, seed=3), 0.4), "f32"),
    "ragged_m": lambda: _revalue(g.random_uniform(1037, 900, 5,
                                                  dtype=np.float32, seed=4),
                                 "f32"),
    "one_row": lambda: _revalue(g.random_uniform(1, 500, 300,
                                                 dtype=np.float32, seed=4),
                                "f32"),
    "stored_zeros": lambda: CsrMatrix(
        3, 4, np.array([0, 2, 2, 5]), np.array([0, 3, 0, 1, 2]),
        np.array([1.5, 0.0, 0.0, -2.0, 3.0], dtype=np.float32)),
}


@pytest.mark.parametrize("name", sorted(PACKS))
def test_pack_holds_every_nonzero_once(name):
    a = PACKS[name]()
    p = fmt.pack_sell_cs(a)
    lens = np.diff(a.rowptr)
    sp = p.slice_ptr.astype(np.int64)
    slen = np.diff(sp) // fmt.SLICE
    assert np.all(np.diff(sp) % fmt.SLICE == 0)
    assert len(p.rows) == p.nslices * fmt.SLICE
    assert p.nslices == -(-a.m // fmt.SLICE)
    # every row once, longest first, -1 past m
    owned = p.rows[p.rows >= 0]
    assert np.array_equal(np.sort(owned), np.arange(a.m))
    assert np.all(p.rows[a.m:] == -1)
    assert np.all(np.diff(lens[owned]) <= 0)
    # slot (j, lane) of a slice: the j-th nonzero of the lane's row in its
    # CSR order, then (column 0, value 0) up to the slice's length
    for i, r in enumerate(p.rows):
        s, lane = divmod(i, fmt.SLICE)
        at = sp[s] + np.arange(slen[s]) * fmt.SLICE + lane
        k = lens[r] if r >= 0 else 0
        if r >= 0:
            lo, hi = a.rowptr[r], a.rowptr[r + 1]
            assert np.array_equal(p.cols[at[:k]], a.colidx[lo:hi])
            assert np.array_equal(p.vals[at[:k]], a.vals[lo:hi])
        assert np.all(p.cols[at[k:]] == 0) and np.all(p.vals[at[k:]] == 0)
    # the padding: each slice's rows filled to its longest
    in_slice = np.zeros(p.nslices * fmt.SLICE, np.int64)
    in_slice[:a.m] = lens[p.rows[:a.m]]
    pad = int((slen[:, None] - in_slice.reshape(-1, fmt.SLICE)).sum())
    assert p.nslots - a.nnz == pad
    assert p.nnz == a.nnz
    assert fmt.layout_bytes(lens) == sum(v.nbytes for v in (
        p.slice_ptr, p.rows, p.cols, p.vals))


def test_sorted_order_pads_least():
    # lengths 1, 9, 1, 9 ... in natural order would pad every slice to 9;
    # sorted, half the slices hold the 9s and half the 1s
    lens = np.tile([1, 9], 64)
    rp = np.concatenate([[0], np.cumsum(lens)])
    a = CsrMatrix(128, 16, rp, np.zeros(rp[-1], np.int32),
                  np.ones(rp[-1], np.float32))
    p = fmt.pack_sell_cs(a)
    assert list(np.diff(p.slice_ptr) // fmt.SLICE) == [9, 9, 1, 1]
    assert p.nslots == a.nnz


def _seq_fma_like(a, x):
    """Each row summed in its CSR order, ``acc + v · x[c]`` in f64 rounded
    to f32 a step: the plain version's arithmetic, row by row."""
    y = np.zeros(a.m, np.float32)
    xd = x.astype(np.float64)
    for r in range(a.m):
        acc = np.float32(0.0)
        for k in range(a.rowptr[r], a.rowptr[r + 1]):
            acc = np.float32(np.float64(acc)
                             + np.float64(a.vals[k]) * xd[a.colidx[k]])
        y[r] = acc
    return y


@pytest.mark.parametrize("name", ["powerlaw", "empty_rows", "ragged_m",
                                  "stored_zeros"])
def test_plain_sums_each_row_in_slot_order(name):
    a = PACKS[name]()
    x = np.random.default_rng(1).standard_normal(a.n).astype(np.float32)
    cs = ops.prepare_cs(fmt.pack_sell_cs(a), "cpu")
    y = ops.cs_spmv(cs, torch.from_numpy(x)).numpy()
    assert y.shape == (a.m,) and y.dtype == np.float32
    assert np.array_equal(y, _seq_fma_like(a, x))


def _hybrid_plans(a):
    """(the CPU plan, the plan for a CUDA device, the prep) of ``a``'s
    hybrid, both built from one ``prepare_hybrid``."""
    prep = prepare_hybrid(a)
    assert prep is not None
    cpu = th._build_plan(a, Method.SELL_C_SIGMA, 0,
                         hints={"hybrid_prep": prep})
    cuda = th._build_plan(a, Method.SELL_C_SIGMA, 0,
                          hints={"hybrid_prep": prep, "device_type": "cuda"})
    return cpu, cuda, prep


def _scaled_err(y, ref, absref):
    d = np.abs(y.astype(np.float64) - ref)
    return float(np.max(np.where(absref > 0, d / np.maximum(absref, 1e-300),
                                 np.where(d > 0, np.inf, 0.0))))


@pytest.mark.parametrize("m,nnz,seed", [(20000, 800_000, 2),
                                        (10000, 300_000, 2),
                                        (50000, 600_000, 4)])
def test_plain_matches_sell8d_and_f64(m, nnz, seed):
    a = _powerlaw(m, nnz, seed)
    cpu, cuda, prep = _hybrid_plans(a)
    assert th.plan_kind(cpu) == "hybrid(8w+8d)"
    assert th.plan_kind(cuda) == "hybrid(split+cs)"
    light = cuda["hybrid"][1]
    assert light["sell_cs"].nnz == prep.sparse.nnz and "rest_rows" not in light
    x = np.random.default_rng(seed).standard_normal(a.n).astype(np.float32)
    xt = torch.from_numpy(x)
    # the light part alone: K12's plain version, SELL-8D's, and f64
    sp = prep.sparse
    ref = st.spmv_golden(sp.astype(np.float64), x.astype(np.float64))
    absref = st.spmv_golden(CsrMatrix(sp.m, sp.n, sp.rowptr, sp.colidx,
                                      np.abs(sp.vals).astype(np.float64)),
                            np.abs(x).astype(np.float64))
    parts = {}
    for kind, plan in (("8d", cpu), ("cs", cuda)):
        placed = th._place(plan["hybrid"][1], "cpu")
        parts[kind] = th._make_bound(Method.SELL_C_SIGMA, placed,
                                     a.m)(xt).numpy()[:a.m]
        assert _scaled_err(parts[kind], ref, absref) <= 1e-5, kind
    assert _scaled_err(parts["cs"], parts["8d"].astype(np.float64),
                       absref) <= 2e-5
    # the whole product: the heavy part on SELL-8W (the CPU's plan) or on
    # row-split CSR (K13, the CUDA plan), the same fold on both
    ys = [th._make_bound(Method.SELL_C_SIGMA, th._place(p, "cpu"),
                         a.m)(xt).numpy() for p in (cpu, cuda)]
    ref = st.spmv_golden(a.astype(np.float64), x.astype(np.float64))
    absref = st.spmv_golden(CsrMatrix(a.m, a.n, a.rowptr, a.colidx,
                                      np.abs(a.vals).astype(np.float64)),
                            np.abs(x).astype(np.float64))
    for y in ys:
        assert _scaled_err(y, ref, absref) <= 1e-4


#: name → (matrix, the value mode of its light part, the plan a CUDA
#: device gets)
ROUTES = {
    "f32": (lambda: _powerlaw(10000, 300_000, 2), "f32",
            "hybrid(split+cs)"),
    "palette": (lambda: _powerlaw(10000, 300_000, 2, "palette"), "palette",
                "hybrid(8w+8d)"),
    "bf16": (lambda: _powerlaw(10000, 300_000, 2, "bf16"), "bf16",
             "hybrid(8w+8d)"),
    "df16": (lambda: _powerlaw(10000, 300_000, 2, "f64"), "df16",
             "hybrid(8w+8d)"),
    "low_padding": (_clustered_heavy, "f32", "hybrid(8w+8d)"),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_planner_takes_the_rule(name):
    make, mode, want = ROUTES[name]
    a = make()
    cpu, cuda, prep = _hybrid_plans(a)
    assert slot_value_mode(prep.sparse.vals, prep.nw,
                           mode.startswith("df")) == mode
    assert cpu["value_mode"] == mode
    assert th.plan_kind(cpu) == "hybrid(8w+8d)"
    assert th.plan_kind(cuda) == want
    bytes_8d = launch_ops.sell_bytes(prep.ts)
    bytes_cs = fmt.layout_bytes(prep.sparse.row_lengths)
    assert want.endswith("+cs)") == (mode == "f32"
                                     and bytes_8d >= 2 * bytes_cs)
    # a CPU handle keeps the JAX planner's route
    h = st.create_handle(a, device="cpu")
    assert th.plan_kind(h.plan) == "hybrid(8w+8d)"


def test_cuda_plan_runs_on_the_cpu():
    # a plan built for a CUDA device, placed and bound on the CPU, through
    # the handle's fold: y within f32 of the CPU handle's
    a = _powerlaw(20000, 800_000, 2)
    h = st.create_handle(a, device="cpu")
    plan = th._build_plan(a, h.method, 0, hints={"device_type": "cuda"})
    assert th.plan_kind(plan) == "hybrid(split+cs)"
    assert plan["value_mode"] == "f32"
    placed = th._place(plan, "cpu")
    assert isinstance(placed["hybrid"][1]["sell_cs"], ops.CsStream)
    fn = th._make_bound(h.method, placed, a.m)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(a.n)
                         .astype(np.float32))
    y, want = fn(x), st.spmv(h, x)
    assert torch.allclose(y, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(fn(x), y)


def test_wrapper_refuses_other_devices_and_types():
    cs = ops.prepare_cs(fmt.pack_sell_cs(PACKS["ragged_m"]()), "cpu")
    with pytest.raises(ValueError, match="no kernel"):
        ops.cs_spmv(cs, torch.zeros(cs.n, device="meta"))
    got = ops.cs_spmv(cs, torch.ones(cs.n, dtype=torch.float64))
    assert got.dtype == torch.float32


def test_decode_gives_the_stored_nonzeros():
    a = PACKS["powerlaw"]()
    rows, cols, vals = ops.cs_decode(ops.prepare_cs(fmt.pack_sell_cs(a),
                                                    "cpu"))
    want = np.stack([np.repeat(np.arange(a.m), np.diff(a.rowptr)),
                     a.colidx])
    got = np.stack([rows.numpy(), cols.numpy()])
    o1 = np.lexsort(want[::-1])
    o2 = np.lexsort(got[::-1])
    assert np.array_equal(want[:, o1], got[:, o2])
    assert np.array_equal(a.vals[o1], vals.numpy()[o2])
