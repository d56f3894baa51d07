"""Row-split CSR with explicit columns (``formats/csr_split.py``, K13's
plain version in ``ops/csr_split.py``) on the CPU: the pack holds every
nonzero once, in CSR order, in pieces of at most P nonzeros; the plain
version sums in the kernel's order and agrees with the f64 reference; the
rule that picks the layout through the planner (as a pure function it is
``test_torch_launch.py``'s); a plan built for a CUDA device runs on the
CPU.  The kernel itself runs on
the card (``chip_smoke.py``'s ``csr_split`` phase)."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import spmv_tpu_torch as st
from spmv_tpu_torch import handle as th
from spmv_tpu_torch import ops as launch_ops
from spmv_tpu_torch.formats import csr_split as fmt
from spmv_tpu_torch.formats.reorder import length_order, reorder_rows
from spmv_tpu_torch.formats.sell8d import prepare_hybrid, slot_value_mode
from spmv_tpu_torch.io import generate as g
from spmv_tpu_torch.ops import csr_split as ops
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


def _powerlaw(m, nnz, seed, kind="f32"):
    return _revalue(g.power_law(m, m, nnz, dtype=np.float32, seed=seed),
                    kind)


def _sorted(a):
    """``a``'s rows longest first, as the hybrid's heavy part holds them."""
    return reorder_rows(a, length_order(a))


def _dense_heavy(m=20000, seed=5, width=128, every=5):
    """Every ``every``-th row ``width`` nonzeros in one 1024-column window,
    the other rows 8 at random columns: a hybrid whose heavy part packs
    densely in SELL-8W."""
    rng = np.random.default_rng(seed)
    hr = np.arange(0, m, every)
    rows = np.repeat(np.setdiff1d(np.arange(m), hr), 8)
    cols = rng.integers(0, m, rows.size)
    r2 = np.repeat(hr, width)
    c2 = np.minimum(np.repeat(hr // 1024 * 1024, width)
                    + np.tile(np.arange(width), len(hr)), m - 1)
    r, c = np.concatenate([rows, r2]), np.concatenate([cols, c2])
    return CsrMatrix.from_coo(m, m, r, c, rng.standard_normal(r.size)
                              .astype(np.float32))


def _hub_rows():
    """Rows of 5,000, 1,537, 1,024, 600, 64, 63, 17, 1 and 0 nonzeros over
    3,000 columns, longest first: pieces of one to ten a row at P 512."""
    rng = np.random.default_rng(6)
    lens = np.array([5000, 1537, 1024, 600, 64, 63, 17, 1, 0])
    rp = np.concatenate([[0], np.cumsum(lens)])
    cols = np.concatenate([np.sort(rng.choice(3000, k, replace=k > 3000))
                           for k in lens])
    return CsrMatrix(len(lens), 3000, rp, cols.astype(np.int32),
                     rng.standard_normal(rp[-1]).astype(np.float32))


#: name → a matrix to pack whole
PACKS = {
    "powerlaw_sorted": lambda: _sorted(_powerlaw(3000, 120_000, 3)),
    "powerlaw_natural": lambda: _powerlaw(3000, 120_000, 3),
    "hubs": _hub_rows,
    "empty_rows": lambda: _revalue(g.with_empty_rows(
        g.random_uniform(1000, 700, 6, dtype=np.float32, seed=3), 0.4), "f32"),
    "one_row": lambda: _revalue(g.random_uniform(1, 5000, 3000,
                                                 dtype=np.float32, seed=4),
                                "f32"),
    "stored_zeros": lambda: CsrMatrix(
        3, 4, np.array([0, 2, 2, 5]), np.array([0, 3, 0, 1, 2]),
        np.array([1.5, 0.0, 0.0, -2.0, 3.0], dtype=np.float32)),
}


@pytest.mark.parametrize("piece", [64, 512, fmt.PIECE])
@pytest.mark.parametrize("name", sorted(PACKS))
def test_pack_holds_every_nonzero_once(name, piece):
    a = PACKS[name]()
    p = fmt.pack_csr_split(a, piece=piece)
    lens = np.diff(a.rowptr).astype(np.int64)
    # the planes are the CSR arrays, each nonzero once, in order
    assert np.array_equal(p.cols, a.colidx)
    assert np.array_equal(p.vals, a.vals) and p.vals.dtype == np.float32
    assert p.nnz == a.nnz
    # the pieces tile the planes in order, none longer than P, each row's
    # consecutive and as even as a cut into ceil(L / P) allows
    ptr = p.piece_ptr.astype(np.int64)
    assert ptr[0] == 0 and ptr[-1] == a.nnz and np.all(np.diff(ptr) >= 0)
    plen = np.diff(ptr)
    assert plen.max(initial=0) <= piece
    count = np.diff(p.row_piece)
    assert np.array_equal(count, np.maximum(-(-lens // piece), 1))
    assert np.array_equal(p.piece_row, np.repeat(np.arange(a.m), count))
    for r in range(a.m):
        at = slice(p.row_piece[r], p.row_piece[r + 1])
        assert ptr[p.row_piece[r]] == a.rowptr[r]
        assert plen[at].sum() == lens[r]
        assert plen[at].max() - plen[at].min() <= 1
    assert p.split_rows == int(np.count_nonzero(lens > piece))
    assert fmt.layout_bytes(lens, piece) == sum(v.nbytes for v in (
        p.piece_ptr, p.piece_row, p.row_piece, p.cols, p.vals))


def _kernel_order(p, x):
    """The kernel's arithmetic, piece by piece in numpy: lane l of a piece
    adds the piece's nonzeros l, l + 32, ... (``acc + v · x[c]`` in f64,
    rounded to f32 a step), a butterfly (xor 16, ..., 1) adds the lanes,
    and a row of several pieces adds their sums in piece order from 0."""
    ptr = p.piece_ptr.astype(np.int64)
    xd = x.astype(np.float64)
    sums = np.zeros(p.npieces, np.float32)
    w = 32
    for q in range(p.npieces):
        lanes = np.zeros(w, np.float32)
        for k in range(ptr[q], ptr[q + 1]):
            ln = (k - ptr[q]) % w
            lanes[ln] = np.float32(np.float64(lanes[ln])
                                   + np.float64(p.vals[k]) * xd[p.cols[k]])
        off = w // 2
        while off:
            lanes = lanes + lanes[np.arange(w) ^ off]
            off //= 2
        sums[q] = lanes[0]
    y = np.zeros(p.m, np.float32)
    for r in range(p.m):
        f, e = p.row_piece[r], p.row_piece[r + 1]
        if e - f == 1:
            y[r] = sums[f]
            continue
        acc = np.float32(0.0)
        for q in range(f, e):
            acc = acc + sums[q]
        y[r] = acc
    return y


def _scaled_err(y, ref, absref):
    d = np.abs(y.astype(np.float64) - ref)
    return float(np.max(np.where(absref > 0, d / np.maximum(absref, 1e-300),
                                 np.where(d > 0, np.inf, 0.0)), initial=0))


@pytest.mark.parametrize("piece", [64, 256, 512, fmt.PIECE])
@pytest.mark.parametrize("name", ["powerlaw_sorted", "powerlaw_natural",
                                  "hubs", "empty_rows", "stored_zeros"])
def test_plain_sums_in_the_kernel_order(name, piece):
    a = PACKS[name]()
    x = np.random.default_rng(1).standard_normal(a.n).astype(np.float32)
    p = fmt.pack_csr_split(a, piece=piece)
    s = ops.prepare_split(p, "cpu")
    y = ops.split_spmv(s, torch.from_numpy(x)).numpy()
    assert y.shape == (a.m,) and y.dtype == np.float32
    assert np.array_equal(y.view(np.int32), _kernel_order(p, x).view(
        np.int32))
    # within f32 rounding of the f64 CSR product
    ref = st.spmv_golden(a.astype(np.float64), x.astype(np.float64))
    absref = st.spmv_golden(CsrMatrix(a.m, a.n, a.rowptr, a.colidx,
                                      np.abs(a.vals).astype(np.float64)),
                            np.abs(x).astype(np.float64))
    assert _scaled_err(y, ref, absref) <= 1e-5
    assert torch.equal(ops.split_spmv(s, torch.from_numpy(x)),
                       torch.from_numpy(y))


@pytest.mark.parametrize("kind,want", [("f32", "f32"), ("palette", "palette"),
                                       ("bf16", "bf16"), ("f64", "df16")])
def test_value_mode_reads_the_values(kind, want):
    # the ladder the planner hands the rule: one SELL-8W column, so the
    # palette's 63 codes
    a = _powerlaw(2000, 40_000, 3, kind)
    assert slot_value_mode(a.vals, 1, kind == "f64") == want


def _light_palette(m=20000, nnz=800_000, seed=2):
    """A power-law matrix whose heavy rows keep gaussian f32 values and
    whose light rows all hold 0.5: the light part a palette, so it keeps
    SELL-8D beside a K13 heavy part."""
    a = _powerlaw(m, nnz, seed)
    heavy = np.zeros(a.m, bool)
    heavy[prepare_hybrid(a).fold_rows] = True
    rows = np.repeat(np.arange(a.m), np.diff(a.rowptr))
    return CsrMatrix(a.m, a.n, a.rowptr, a.colidx,
                     np.where(heavy[rows], a.vals, np.float32(0.5)))


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


#: name → (matrix, the value mode of its heavy part, the plan a CUDA
#: device gets, the plan the CPU gets)
ROUTES = {
    "f32": (lambda: _powerlaw(20000, 800_000, 2), "f32",
            "hybrid(split+cs)", "hybrid(8w+8d)"),
    "palette": (lambda: _powerlaw(10000, 300_000, 2, "palette"), "palette",
                "hybrid(8w+8d)", "hybrid(8w+8d)"),
    "bf16": (lambda: _powerlaw(10000, 300_000, 2, "bf16"), "bf16",
             "hybrid(8w+8d)", "hybrid(8w+8d)"),
    "f64": (lambda: _powerlaw(10000, 300_000, 2, "f64"), "df16",
            "hybrid(8w+8d)", "hybrid(8w+8d)"),
    "dense_heavy": (_dense_heavy, "f32", "hybrid(8w+cs)", "hybrid(8w+8d)"),
    "light_palette": (_light_palette, "f32", "hybrid(split+8d)",
                      "hybrid(8w+8d)"),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_planner_takes_the_rule(name):
    make, mode, want, want_cpu = ROUTES[name]
    a = make()
    cpu, cuda, prep = _hybrid_plans(a)
    dense = prep.dense_sorted
    assert slot_value_mode(dense.vals, 1, name == "f64") == mode
    assert th.plan_kind(cpu) == want_cpu
    assert th.plan_kind(cuda) == want
    ratio = (launch_ops.sell_bytes(prep.td)
             / fmt.layout_bytes(dense.row_lengths))
    split = want.startswith("hybrid(split")
    assert split == (mode == "f32" and ratio >= 2)
    heavy = cuda["hybrid"][0]
    if split:
        # the heavy rows in their order, the fold unchanged
        assert "sell8w_v2" not in heavy and "mega_sub_rows" not in heavy
        assert np.array_equal(heavy["fold_rows"], cpu["hybrid"][0]
                              ["fold_rows"])
        assert heavy["m_rows"] == dense.m == heavy["csr_split"].m
        info = th.describe(cuda)
        assert info["kind"] == want
        assert info["heavy"]["split_rows"] == heavy["csr_split"].split_rows
        assert info["heavy"]["piece"] == fmt.PIECE
        assert info["heavy"]["pieces"] == heavy["csr_split"].npieces
    else:
        assert "sell8w_v2" in heavy and "heavy" not in th.describe(cuda)


def test_cpu_handle_keeps_the_jax_route():
    a = ROUTES["f32"][0]()
    h = st.create_handle(a, device="cpu")
    assert th.plan_kind(h.plan) == "hybrid(8w+8d)"


def _bound_on_the_cpu(name):
    """ROUTES[name]'s matrix, its CUDA plan placed and bound on the CPU,
    an x, and y, held within f32 of the f64 product and to itself on a
    second call."""
    make, _mode, want, _cpu = ROUTES[name]
    a = make()
    plan = th._build_plan(a, Method.SELL_C_SIGMA, 0,
                          hints={"device_type": "cuda"})
    assert th.plan_kind(plan) == want
    placed = th._place(plan, "cpu")
    assert th.describe(placed) == th.describe(plan)
    fn = th._make_bound(Method.SELL_C_SIGMA, placed, a.m)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(a.n)
                         .astype(np.float32))
    y = fn(x)
    ref = st.spmv_golden(a.astype(np.float64), x.numpy().astype(np.float64))
    absref = st.spmv_golden(CsrMatrix(a.m, a.n, a.rowptr, a.colidx,
                                      np.abs(a.vals).astype(np.float64)),
                            np.abs(x.numpy()).astype(np.float64))
    assert _scaled_err(y.numpy(), ref, absref) <= 1e-5
    assert torch.equal(fn(x), y)
    return placed, x, y


@pytest.mark.parametrize("name", ["dense_heavy", "light_palette"])
def test_cuda_plan_runs_on_the_cpu_other_routes(name):
    # the CUDA routes beside hybrid(split+cs): K1 row's heavy part with
    # K12's light part, and K13's heavy part with SELL-8D's light part
    placed, _x, _y = _bound_on_the_cpu(name)
    heavy, light = placed["hybrid"]
    assert ("csr_split" in heavy) == (name == "light_palette")
    assert ("sell_cs" in light) == (name == "dense_heavy")


def test_cuda_plan_runs_on_the_cpu():
    # a plan built for a CUDA device, placed and bound on the CPU: the heavy
    # part's plain version and the fold, y within f32 of the f64 product
    # and bit for bit the parts' plain versions folded by hand
    placed, x, y = _bound_on_the_cpu("f32")
    heavy, light = placed["hybrid"]
    assert isinstance(heavy["csr_split"], ops.SplitStream)
    from spmv_tpu_torch.ops import sell_cs
    want = sell_cs.cs_plain(light["sell_cs"], x).index_add_(
        0, heavy["fold_rows"], ops.split_plain(heavy["csr_split"], x))
    assert torch.equal(y, want)


def test_int32_overflow_is_refused():
    # the guard reads the counts before any array: nonzeros and pieces (at
    # most nnz + m) and columns must fit int32
    for m, nnz, n in ((2, 2 ** 31, 3), (2 ** 30, 2 ** 30, 3),
                      (2, 2, 2 ** 31)):
        with pytest.raises(ValueError, match="int32"):
            fmt.pack_csr_split(types.SimpleNamespace(m=m, n=n, nnz=nnz))


def test_pack_refuses_an_empty_piece():
    for piece in (0, -1):
        with pytest.raises(ValueError, match="piece"):
            fmt.pack_csr_split(PACKS["hubs"](), piece=piece)


class _OnCuda:
    """Just enough of a CUDA tensor for the wrapper's checks."""

    def __init__(self, n, dtype):
        self.device = torch.device("cuda", 0)
        self.dtype, self.shape = dtype, (n,)

    def is_contiguous(self):
        return True


def test_wrapper_refuses_other_devices_and_types():
    s = ops.prepare_split(fmt.pack_csr_split(PACKS["hubs"]()), "cpu")
    with pytest.raises(ValueError, match="no kernel"):
        ops.split_spmv(s, torch.zeros(s.n, device="meta"))
    for dt in (torch.float64, torch.bfloat16):
        with pytest.raises(ValueError, match="float32"):
            ops.split_spmv(s, _OnCuda(s.n, dt))
    with pytest.raises(ValueError, match="float32"):
        ops.split_spmv(s, _OnCuda(s.n + 1, torch.float32))
    # the CPU's plain version takes x in any float type, as f32
    got = ops.split_spmv(s, torch.ones(s.n, dtype=torch.float64))
    assert got.dtype == torch.float32
    assert torch.equal(got, ops.split_spmv(s, torch.ones(s.n)))


def test_tickets_one_set_a_stream():
    # the one ``ops.tickets`` of the SELL kernel and K13, at K13's size
    s = ops.prepare_split(fmt.pack_csr_split(PACKS["hubs"]()), "cpu")
    t1, t2 = launch_ops.tickets(s, (0, 1)), launch_ops.tickets(s, (0, 2))
    assert t1 is not t2 and t1 is launch_ops.tickets(s, (0, 1))
    assert t1.shape == (s.m,) and t1.dtype == torch.int32
    assert not t1.any()
    assert not dataclasses.replace(s).tickets_by_stream


@pytest.mark.parametrize("name", ["powerlaw_sorted", "hubs", "stored_zeros"])
def test_decode_gives_the_stored_nonzeros(name):
    a = PACKS[name]()
    rows, cols, vals = ops.split_decode(
        ops.prepare_split(fmt.pack_csr_split(a, piece=256), "cpu"))
    assert np.array_equal(rows.numpy(), np.repeat(np.arange(a.m),
                                                  np.diff(a.rowptr)))
    assert np.array_equal(cols.numpy(), a.colidx)
    assert np.array_equal(vals.numpy(), a.vals)
