"""The port's two-pass COO2 plan (Method.CSR5) against the JAX package:
the pack (``spmv_tpu_torch/formats/coo2.py``, bit-identical), pass 1
(``ops/coo2.py``'s plain version of the CUDA kernel against
``spmv_tpu.ops.pallas_coo2._pass1`` in interpret mode, K8), pass 2 (the
binary SELL stream's plain version against
``build_sell8w_v2w_fn(binary=True)`` in interpret mode, K5) and the whole
plan (against ``build_coo2_fn`` in interpret mode and ``spmv_golden``).

Tolerances:
- pass 1: exact — one f32 product a slot, the same rounding on both sides;
- pass 2 and the whole plan: 1e-5·(|A||x|)_i per row — f32 sums taken in
  another order.
"""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import spmv_tpu.native as j_native
from spmv_tpu.formats.coo2 import pack_coo2 as j_pack_coo2
from spmv_tpu.formats.sell8w import pack_sell8w as j_pack_sell8w
from spmv_tpu.io import generate as j_gen
from spmv_tpu.ops.pallas_coo2 import _pass1, build_coo2_fn
from spmv_tpu.ops.pallas_sell import build_sell8w_v2w_fn
from spmv_tpu.oracle import spmv_golden
import spmv_tpu_torch.native as t_native
from spmv_tpu_torch.formats import coo2 as t_coo2
from spmv_tpu_torch.formats.sell8w import pack_sell8w as t_pack_sell8w
from spmv_tpu_torch.io import generate as t_gen
from spmv_tpu_torch.ops import coo2 as t_ops
from spmv_tpu_torch.ops import sell as t_sell
from spmv_tpu_torch.types import CsrMatrix

#: the shapes of tests/test_coo2.py
SHAPES = {
    "uniform": lambda g: g.random_uniform(2000, 2000, 40, seed=42),
    "powerlaw": lambda g: g.power_law(1500, 1500, 40000, seed=3),
    "rect": lambda g: g.random_uniform(700, 2500, 15, seed=2),
    "empty_rows": lambda g: g.with_empty_rows(
        g.random_uniform(600, 500, 8, seed=4), 0.4),
}


def _f32(a):
    return a.astype(np.float32)


def _same_pack(p, q):
    """Two Coo2 packs hold the same arrays, R's fields included."""
    for f in ("m", "n", "nnz_stored", "ntiles"):
        assert getattr(p, f) == getattr(q, f), f
    for f in ("window_ids", "meta", "vals"):
        u, v = np.asarray(getattr(p, f)), np.asarray(getattr(q, f))
        assert u.dtype == v.dtype and np.array_equal(u, v), f
    for f in dataclasses.fields(q.reduce_plan):
        u = getattr(p.reduce_plan, f.name)
        v = getattr(q.reduce_plan, f.name)
        if isinstance(v, np.ndarray):
            assert u.dtype == v.dtype and np.array_equal(u, v), f.name
        else:
            assert u == v, f.name


def _abs_ax(a, x):
    aa = CsrMatrix(a.m, a.n, a.rowptr, a.colidx, np.abs(a.vals))
    return spmv_golden(aa.astype(np.float64),
                       np.abs(x).astype(np.float64)) + 1e-300


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_native_pack_matches_reference(name):
    a, ja = _f32(SHAPES[name](t_gen)), _f32(SHAPES[name](j_gen))
    before = dict(t_coo2.packs)
    p = t_coo2.pack_coo2(a)
    # the fused C++ pipeline packed: the Python placer takes minutes at
    # millions of nonzeros and would otherwise go unnoticed
    assert t_coo2.packs["native"] == before["native"] + 1
    assert t_coo2.packs["python"] == before["python"]
    _same_pack(p, j_pack_coo2(ja))
    assert p.reduce_plan.nnz_stored == a.nnz
    assert int((p.vals != 0).sum()) <= a.nnz


@pytest.mark.parametrize("path", ["native_place", "python"])
def test_numpy_pack_matches_reference(path, monkeypatch):
    # the numpy sort, then the C++ placer or the Python one, in both
    # packages
    for mod in (j_native, t_native):
        monkeypatch.setattr(mod, "coo2_pack_all_native", lambda *a: None)
        if path == "python":
            monkeypatch.setattr(mod, "coo2_place_native", lambda *a: None)
    make = SHAPES["empty_rows"]
    before = t_coo2.packs[path]
    p = t_coo2.pack_coo2(_f32(make(t_gen)), max_pad2=8.0)
    assert t_coo2.packs[path] == before + 1
    _same_pack(p, j_pack_coo2(_f32(make(j_gen)), max_pad2=8.0))


def test_pass2_gate_raises():
    # thin rows scattered over a wide n: the pass-2 padding explodes
    make = lambda g: g.random_uniform(2000, 300_000, 4, seed=5)  # noqa: E731
    with pytest.raises(ValueError):
        j_pack_coo2(_f32(make(j_gen)), max_pad2=8.0)
    with pytest.raises(ValueError, match="pass-2"):
        t_coo2.pack_coo2(_f32(make(t_gen)), max_pad2=8.0)


def _pass1_reference(plan, x):
    """The TPU kernel _pass1 in interpret mode on the plan's arrays."""
    vals = plan.vals
    if vals.dtype == torch.bfloat16:
        vals = vals.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    else:
        vals = vals.numpy()
    out = _pass1(jnp.asarray(plan.window_ids.numpy()), jnp.asarray(x),
                 jnp.asarray(plan.meta.numpy()), jnp.asarray(vals),
                 ntiles=plan.ntiles, n=plan.n, interpret=True)
    return np.asarray(out).reshape(-1)


@pytest.mark.parametrize("values", ["f32", "bf16"])
def test_pass1_matches_tpu_kernel(values):
    # packed streams: gaussian values stay f32, k/8 values go bf16
    a = t_gen.random_uniform(1500, 3000, 20, seed=7,
                             exact=values == "bf16").astype(np.float32)
    plan = t_ops.prepare_coo2(t_coo2.pack_coo2(a), "cpu")
    want = torch.bfloat16 if values == "bf16" else torch.float32
    assert plan.vals.dtype == want and plan.ntiles % t_ops.G1 == 0
    x = np.random.default_rng(1).standard_normal(a.n).astype(np.float32)
    got = t_ops.coo2_pass1(plan, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _pass1_reference(plan, x))


def _chunks(ntiles):
    return torch.from_numpy(t_ops.chunk_bounds(ntiles, t_sell.H100_SMS))


def test_pass1_random_stream_reads_s_at_the_cell():
    # random (s, r) in every slot, random windows, a ragged last window:
    # every decode rule, columns past n read 0
    rng = np.random.default_rng(3)
    ntiles, n = 32, 5 * 1024 - 300
    meta = (rng.integers(0, 8, (ntiles, 8, 128)) << 7
            | rng.integers(0, 128, (ntiles, 8, 128))).astype(np.int16)
    # slot (2, 5) of tile 4 names r = 9 and carries s = 1; the cell (2, 9)
    # says s = 6: the cell wins
    meta[4, 2, 5] = (1 << 7) | 9
    meta[4, 2, 9] = (6 << 7) | 77
    window_ids = rng.integers(0, 5, ntiles).astype(np.int32)
    window_ids[4] = 1
    vals = rng.standard_normal((ntiles, 8, 128)).astype(np.float32)
    plan = t_ops.Coo2Plan(m=0, n=n, ntiles=ntiles,
                          window_ids=torch.from_numpy(window_ids),
                          meta=torch.from_numpy(meta),
                          vals=torch.from_numpy(vals), reduce=None,
                          chunk_ptr=_chunks(ntiles))
    x = rng.standard_normal(n).astype(np.float32)
    got = t_ops.coo2_pass1(plan, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _pass1_reference(plan, x))
    assert got[4 * 1024 + 2 * 128 + 5] == vals[4, 2, 5] * x[1024 + 6 * 128
                                                          + 9]
    assert (window_ids == 4).any() and n < 5 * 1024   # some reads past n


def _random_stream(rng, ntiles, n, bf16=False):
    """A plan over random (s, r) slots and random windows of [0, n)."""
    meta = (rng.integers(0, 8, (ntiles, 8, 128)) << 7
            | rng.integers(0, 128, (ntiles, 8, 128))).astype(np.int16)
    window_ids = rng.integers(0, -(-n // 1024), ntiles).astype(np.int32)
    if bf16:
        vals = torch.from_numpy(
            (rng.integers(-255, 256, (ntiles, 8, 128)) / 32.0)
            .astype(np.float32)).to(torch.bfloat16)
    else:
        vals = torch.from_numpy(
            rng.standard_normal((ntiles, 8, 128)).astype(np.float32))
    return t_ops.Coo2Plan(m=0, n=n, ntiles=ntiles,
                          window_ids=torch.from_numpy(window_ids),
                          meta=torch.from_numpy(meta), vals=vals,
                          reduce=None, chunk_ptr=_chunks(ntiles))


@pytest.mark.parametrize("values", ["f32", "bf16"])
@pytest.mark.parametrize("tail", [1, 2, 3])
def test_pass1_ragged_last_window(tail, values):
    # n = 3·1024 + tail ≡ tail (mod 4): the last window has fewer columns
    # than one 16-B word, so the kernel stages none of it and reads them
    # from device memory; tile 5 sits in that window and reads each of them
    rng = np.random.default_rng(10 + tail)
    n = 3 * 1024 + tail
    plan = _random_stream(rng, 32, n, bf16=values == "bf16")
    plan.window_ids[5] = 3
    plan.meta[5, 0, :tail] = torch.arange(tail)   # r, and s = 0 at the cell
    x = rng.standard_normal(n).astype(np.float32)
    got = t_ops.coo2_pass1(plan, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _pass1_reference(plan, x))
    vals = plan.vals.to(torch.float32).numpy()
    for r in range(tail):
        assert got[5 * 1024 + r] == vals[5, 0, r] * x[3072 + r]
    assert (got[5 * 1024:6 * 1024] == 0).any()      # columns past n read 0


@pytest.mark.parametrize("tail", [1, 2, 3])
def test_pass1_packed_ragged_n(tail):
    # a packed stream whose n ≡ tail (mod 4), its last columns read
    n = 2048 + tail
    a = t_gen.random_uniform(600, n, 24, seed=tail).astype(np.float32)
    assert a.colidx.max() == n - 1
    plan = t_ops.prepare_coo2(t_coo2.pack_coo2(a), "cpu")
    x = np.random.default_rng(tail).standard_normal(n).astype(np.float32)
    got = t_ops.coo2_pass1(plan, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _pass1_reference(plan, x))


@pytest.mark.parametrize("ntiles", [16, 6_688, 37_776])
def test_chunk_bounds_cover_every_tile_once(ntiles):
    b = t_ops.chunk_bounds(ntiles, t_sell.H100_SMS)
    assert b.dtype == np.int32 and b[0] == 0 and b[-1] == ntiles
    lens = np.diff(b)
    assert (lens > 0).all() and lens.sum() == ntiles   # none empty
    step = t_sell.chunk_len(ntiles, t_sell.H100_SMS)
    assert (lens[:-1] == step).all() and lens[-1] <= step
    assert step <= t_sell.CHUNK_TILES
    assert len(lens) == -(-ntiles // step)


def test_prepare_places_aligned_arrays_and_takes_an_x_view():
    a = _f32(SHAPES["rect"](t_gen))
    plan = t_ops.prepare_coo2(t_coo2.pack_coo2(a), "cpu")
    for t in (plan.meta, plan.vals, plan.window_ids, plan.chunk_ptr):
        assert t.data_ptr() % 16 == 0
    np.testing.assert_array_equal(
        plan.chunk_ptr.numpy(), t_ops.chunk_bounds(plan.ntiles,
                                                   t_sell.H100_SMS))
    buf = torch.from_numpy(np.random.default_rng(2).standard_normal(
        a.n + 1).astype(np.float32))
    view = buf[1:]                     # x at element offset 1
    assert view.data_ptr() % 16 == 4 and view.is_contiguous()
    np.testing.assert_array_equal(
        t_ops.coo2_pass1(plan, view).numpy(),
        t_ops.coo2_pass1(plan, view.clone()).numpy())
    np.testing.assert_array_equal(t_ops.coo2_pass1(plan, view).numpy(),
                                  _pass1_reference(plan, view.numpy()))


def _binary_reference(packed_j, x, g):
    return np.asarray(build_sell8w_v2w_fn(packed_j, g=g, binary=True,
                                          interpret=True)(x),
                      dtype=np.float64)


@pytest.mark.parametrize("g", [4, 16])
def test_binary_stream_matches_tpu_kernel(g):
    # tests/test_sell8w_v2w.py's R-like 0/1 matrix with clustered positions
    def ones(gen):
        a = gen.clustered(400, 4096, 6, spread=300, dtype=np.float32,
                          seed=3)
        return CsrMatrix(a.m, a.n, a.rowptr, a.colidx,
                         np.ones(a.nnz, dtype=np.float32))
    a = ones(t_gen)
    x = np.random.default_rng(3).standard_normal(a.n).astype(np.float32)
    v2 = t_sell.binary_v2(t_pack_sell8w(a), g=g)
    assert v2.value_mode == "binary" and v2.vals is None
    st = t_sell.prepare_sell(v2, "cpu", slot_mode=False)
    assert t_sell.kernel_name(st) == "sell_row_bin"
    y = t_sell.sell_spmv(st, torch.from_numpy(x)).numpy()[:a.m]
    ref = _binary_reference(j_pack_sell8w(ones(j_gen)), x, g)
    bound = 1e-5 * _abs_ax(a, x)
    np.testing.assert_array_less(np.abs(y - ref), bound)
    np.testing.assert_array_less(
        np.abs(y - spmv_golden(a.astype(np.float64), x.astype(np.float64))),
        bound)


def test_binary_reduce_of_a_coo2_pack_selects():
    # R of a real pack over a product stream that is NaN at every position
    # no row reads: the binary mode selects (K5's jnp.where), so padding
    # slots add nothing even there
    make = SHAPES["powerlaw"]
    a = _f32(make(t_gen))
    r = t_coo2.pack_coo2(a).reduce_plan
    st = t_sell.prepare_sell(t_sell.binary_v2(r), "cpu", slot_mode=False)
    _rows, col, v = t_sell.sell_decode(st)
    used = np.zeros(r.n, bool)
    used[col[v != 0].numpy()] = True
    assert used.sum() == a.nnz
    p = np.random.default_rng(5).standard_normal(r.n).astype(np.float32)
    p_nan = np.where(used, p, np.nan).astype(np.float32)
    y = t_sell.sell_spmv(st, torch.from_numpy(p_nan)).numpy()[:a.m]
    ref = _binary_reference(j_pack_coo2(_f32(make(j_gen))).reduce_plan,
                            p_nan, 16)
    assert np.isfinite(y).all() and np.isfinite(ref).all()
    p_used = torch.from_numpy(np.where(used, p, 0.0).astype(np.float32))
    clean = t_sell.sell_plain(st, p_used).numpy()[:a.m]
    bound = 1e-5 * t_sell.sell_plain(st, p_used.abs()).numpy()[:a.m] + 1e-30
    np.testing.assert_array_less(np.abs(y - ref), bound)
    np.testing.assert_array_equal(y, clean)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plan_matches_reference(name):
    a, ja = _f32(SHAPES[name](t_gen)), _f32(SHAPES[name](j_gen))
    x = np.random.default_rng(0).standard_normal(a.n).astype(np.float32)
    plan = t_ops.prepare_coo2(t_coo2.pack_coo2(a), "cpu")
    y = t_ops.coo2_spmv(plan, torch.from_numpy(x)).numpy()
    assert y.shape == (a.m,) and y.dtype == np.float32
    bound = 1e-5 * _abs_ax(a, x)
    ref = np.asarray(build_coo2_fn(j_pack_coo2(ja), interpret=True)(x))
    np.testing.assert_array_less(np.abs(y - ref), bound)
    np.testing.assert_array_less(
        np.abs(y - spmv_golden(a.astype(np.float64), x.astype(np.float64))),
        bound)


def test_wrappers_take_no_other_device():
    a = _f32(SHAPES["rect"](t_gen))
    plan = t_ops.prepare_coo2(t_coo2.pack_coo2(a), "cpu")
    with pytest.raises(ValueError):
        t_ops.coo2_pass1(plan, torch.empty(a.n, device="meta"))
    with pytest.raises(ValueError):
        t_sell.sell_spmv(plan.reduce, torch.empty(plan.reduce.n,
                                                  device="meta"))
