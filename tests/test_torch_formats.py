"""The port's host layer (jax-free copies in spmv_tpu_torch) pinned to the
JAX package's originals: generators, packers (bit-identical arrays, bf16
compared as its uint16 bits; past 2M columns too: column stripes, the
windowed slot pack, SELL-8W), the numpy bf16 conversion, the cost gate's
estimates and constants, and the AUTO method choice."""

import dataclasses

import ml_dtypes
import numpy as np
import pytest

from spmv_tpu import inspector as j_insp
from spmv_tpu.formats import bcsr as j_bcsr, dia as j_dia
from spmv_tpu.formats import sell8d as j_8d, sell8w as j_8w
from spmv_tpu.io import generate as j_gen
from spmv_tpu.types import CsrMatrix as JaxCsr
from spmv_tpu_torch import inspector as t_insp
from spmv_tpu_torch.formats import _bf16
from spmv_tpu_torch.formats import bcsr as t_bcsr, dia as t_dia
from spmv_tpu_torch.formats import sell8d as t_8d, sell8w as t_8w
from spmv_tpu_torch.io import generate as t_gen
from spmv_tpu_torch.native import native_available
from spmv_tpu_torch.types import CsrMatrix as TorchCsr


def _bits(a):
    """Array → comparable numpy array (bf16 of either package → uint16)."""
    if a is None:
        return None
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _same(x, y):
    if dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            _same(getattr(x, f.name), getattr(y, f.name))
    elif isinstance(x, (tuple, list)):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            _same(u, v)
    elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        bx, by = _bits(x), _bits(y)
        assert bx.dtype == by.dtype and bx.shape == by.shape
        assert np.array_equal(bx, by, equal_nan=bx.dtype.kind == "f")
    else:
        assert x == y


def _both(make):
    """The same generator call in both packages (identical arrays)."""
    j, t = make(j_gen), make(t_gen)
    _same((j.m, j.n, j.rowptr, j.colidx, j.vals),
          (t.m, t.n, t.rowptr, t.colidx, t.vals))
    return j, t


def _revalue(a, vals, cls):
    return cls(a.m, a.n, a.rowptr, a.colidx, vals.astype(np.float32))


def test_native_packer_builds():
    assert native_available()


def test_bf16_matches_ml_dtypes():
    rng = np.random.default_rng(0)
    edge = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-45,
                     -1e-45, 1e-39, 3.4028235e38, -3.4028235e38,
                     1.00390625, 1.01171875, 1.0078125, 65504.0],
                    np.float32)
    v = np.concatenate([
        edge, rng.standard_normal(50_000).astype(np.float32),
        rng.integers(0, 2 ** 32, 200_000, dtype=np.uint64)
        .astype(np.uint32).view(np.float32)])
    with np.errstate(invalid="ignore"):
        ref = v.astype(ml_dtypes.bfloat16)
    assert np.array_equal(_bf16.from_f32(v), ref.view(np.uint16))
    ok = ~np.isnan(v)
    assert np.array_equal(_bf16.to_f32(_bf16.from_f32(v))[ok],
                          ref.astype(np.float32)[ok])
    exact = ref.astype(np.float32)[ok]
    assert _bf16.is_lossless(exact)
    assert not _bf16.is_lossless(np.float32([1.0, 1.0 + 2 ** -10]))


@pytest.mark.parametrize("compress,exact", [("lossless", True),
                                            ("lossless", False),
                                            ("bf16", False)])
def test_pack_dia_identical(compress, exact):
    j, t = _both(lambda g: g.banded(3000, 3200, 5, dtype=np.float32,
                                    seed=7, exact=exact))
    _same(j_dia.pack_dia(j, compress=compress),
          t_dia.pack_dia(t, compress=compress))
    assert j_dia.dia_profile(j) == t_dia.dia_profile(t)


@pytest.mark.parametrize("values", ["palette", "bf16", "f32"])
def test_pack_sell8w_and_plan_v2_identical(values):
    j, t = _both(lambda g: g.clustered(4000, 6000, 10, spread=400,
                                       dtype=np.float32, seed=3))
    rng = np.random.default_rng(1)
    if values == "bf16":
        v = rng.integers(1, 256, j.nnz) / 64.0
        j, t = _revalue(j, v, JaxCsr), _revalue(t, v, TorchCsr)
    elif values == "f32":
        v = rng.standard_normal(j.nnz)
        j, t = _revalue(j, v, JaxCsr), _revalue(t, v, TorchCsr)
    pj, pt = j_8w.pack_sell8w(j), t_8w.pack_sell8w(t)
    _same(pj, pt)
    vj, vt = j_8w.plan_v2(pj), t_8w.plan_v2(pt)
    assert vt.value_mode == values
    _same(vj, vt)
    assert j_8w.estimate_sell8w_tiles(j) == t_8w.estimate_sell8w_tiles(t)


@pytest.mark.parametrize("nw,cell_w", [(1, False), (2, False), (2, True),
                                       (4, False), (4, True), (8, False),
                                       (8, True)])
def test_pack_sell8d_identical(nw, cell_w):
    j, t = _both(lambda g: g.random_uniform(5000, 50000, 8,
                                            dtype=np.float32, seed=nw))
    if nw == 8:       # 8 palette entries at nw=8 — force a bf16 stream
        v = np.random.default_rng(2).integers(1, 256, j.nnz) / 32.0
        j, t = _revalue(j, v, JaxCsr), _revalue(t, v, TorchCsr)
    kw = dict(g="auto", max_pad_ratio=256.0, max_spill=0.05, nw=nw,
              cell_w=cell_w)
    pj, rj = j_8d.pack_sell8d(j, **kw)
    pt, rt = t_8d.pack_sell8d(t, **kw)
    _same(pj, pt)
    _same(rj, rt)
    assert (j_8d.estimate_sell8d_auto(j, nw=None)
            == t_8d.estimate_sell8d_auto(t, nw=None))


def test_prepare_hybrid_identical():
    j, t = _both(lambda g: g.power_law(20000, 20000, 400_000,
                                       dtype=np.float32, seed=2))
    hj, ht = j_8d.prepare_hybrid(j), t_8d.prepare_hybrid(t)
    for f in ("td", "ts", "spilled", "nw", "dense_frac", "cost"):
        assert getattr(hj, f) == getattr(ht, f)
    _same(hj.fold_rows, ht.fold_rows)
    _same((hj.sparse.rowptr, hj.sparse.colidx, hj.sparse.vals),
          (ht.sparse.rowptr, ht.sparse.colidx, ht.sparse.vals))


def test_pack_bcsr_identical():
    j, t = _both(lambda g: g.block_random(3, 4, blocks_per_row=2,
                                          fill=0.3, dtype=np.float32,
                                          seed=1))
    _same(j_bcsr.pack_bcsr(j), t_bcsr.pack_bcsr(t))


def test_choose_method_agrees_on_zoo(matrices):
    for name, a in matrices.items():
        t = TorchCsr(a.m, a.n, a.rowptr, a.colidx, a.vals)
        assert j_insp.choose_method(a) == t_insp.choose_method(t), name
        _same(dataclasses.astuple(j_insp.featurize(a)),
              dataclasses.astuple(t_insp.featurize(t)))


# -- f64: the double-float branches the f64 main path packs with ------------

def _f64_values(j, t, value_mode, entries=64, seed=1):
    """Both packages' matrices with the same f64 values for ``value_mode``
    (palette_df: few distinct values; else full-mantissa values over a
    wide exponent range)."""
    rng = np.random.default_rng(seed)
    if value_mode == "palette_df":
        v = rng.standard_normal(entries - 1)[rng.integers(0, entries - 1,
                                                          j.nnz)]
    else:
        v = rng.standard_normal(j.nnz) * np.exp(rng.uniform(-20, 20, j.nnz))
    return (JaxCsr(j.m, j.n, j.rowptr, j.colidx, v),
            TorchCsr(t.m, t.n, t.rowptr, t.colidx, v))


@pytest.mark.parametrize("value_mode", ["df", "df16", "palette_df"])
def test_pack_sell8w_and_plan_v2_identical_f64(value_mode):
    j, t = _both(lambda g: g.clustered(4000, 6000, 10, spread=400,
                                       dtype=np.float32, seed=3))
    j, t = _f64_values(j, t, value_mode)

    def double_pack(mod, a, cls):
        hi = mod.pack_sell8w(a)
        lo = mod.pack_sell8w(cls(a.m, a.n, a.rowptr, a.colidx,
                                 (a.vals - a.vals.astype(np.float32))
                                 .astype(np.float32)))
        return mod.plan_v2(hi, lo_tiles=lo.vals,
                           force_value_mode=None if value_mode == "df16"
                           else value_mode)

    vj, vt = double_pack(j_8w, j, JaxCsr), double_pack(t_8w, t, TorchCsr)
    assert vt.value_mode == value_mode
    _same(vj, vt)


@pytest.mark.parametrize("nw,cell_w,value_mode", [
    (1, False, "df16"), (2, True, "df"), (4, True, "palette_df"),
    (8, True, "df16")])
def test_pack_sell8d_identical_f64(nw, cell_w, value_mode):
    j, t = _both(lambda g: g.random_uniform(5000, 50000, 8,
                                            dtype=np.float32, seed=nw))
    j, t = _f64_values(j, t, value_mode, entries=64 >> (nw.bit_length() - 1))
    kw = dict(g="auto", max_pad_ratio=256.0, max_spill=0.05, nw=nw,
              cell_w=cell_w)
    if value_mode == "df":
        kw["force_value_mode"] = "df"
    pj, rj = j_8d.pack_sell8d(j, **kw)
    pt, rt = t_8d.pack_sell8d(t, **kw)
    assert pt.value_mode == value_mode
    _same(pj, pt)
    _same(rj, rt)
    assert (j_8d.estimate_sell8d_auto(j, nw=None)
            == t_8d.estimate_sell8d_auto(t, nw=None))


def test_df16_codec_and_cost_tables_identical():
    rng = np.random.default_rng(7)
    v = rng.standard_normal(100_000) * np.exp(rng.uniform(-60, 60, 100_000))
    vh = v.astype(np.float32)
    _same(j_8w.df16_encode_lo(vh, v - vh.astype(np.float64)),
          t_8w.df16_encode_lo(vh, v - vh.astype(np.float64)))
    for vals in (v, np.array([1.0, 2.0 ** -120]), np.array([1.0, np.inf])):
        assert j_8w.df16_safe(vals) == t_8w.df16_safe(vals)
    for windowed in (False, True):
        for df in (False, True, "df"):
            assert (j_8d.cost_tables(windowed, df)
                    == t_8d.cost_tables(windowed, df))
    for df in (False, True, "df"):
        assert j_8d.dense_tile_ns(df) == t_8d.dense_tile_ns(df)
    for vals in (v, v[:63].repeat(100), v.astype(np.float32)):
        for nw in (1, 8):
            for df in (False, True):
                assert (j_8d.slot_stream_budget(vals, nw, df)
                        == t_8d.slot_stream_budget(vals, nw, df))


def test_prepare_hybrid_and_fold_entries_identical_f64():
    import spmv_tpu.handle as jh
    from spmv_tpu_torch import handle as th
    j, t = _both(lambda g: g.power_law(10000, 10000, 400_000,
                                       dtype=np.float32, seed=2))
    j, t = _f64_values(j, t, "df16", seed=7)
    hj, ht = j_8d.prepare_hybrid(j), t_8d.prepare_hybrid(t)
    for f in ("td", "ts", "spilled", "nw", "dense_frac", "cost"):
        assert getattr(hj, f) == getattr(ht, f)
    _same(hj.fold_rows, ht.fold_rows)
    ej = jh._append_fold_entries(hj.sparse, hj.fold_rows, np.float64)
    et = th._append_fold_entries(ht.sparse, ht.fold_rows, np.float64)
    _same((ej.m, ej.n, ej.rowptr, ej.colidx, ej.vals),
          (et.m, et.n, et.rowptr, et.colidx, et.vals))


def test_pack_dia_identical_f64():
    j, t = _both(lambda g: g.banded(3000, 3200, 5, dtype=np.float32,
                                    seed=7, exact=False))
    j, t = _f64_values(j, t, "df")
    dj, dt = j_dia.pack_dia(j), t_dia.pack_dia(t)
    assert dt.data.dtype == np.float64
    _same(dj, dt)


# -- n > 2M: column stripes, the windowed slot pack, SELL-8W -----------------

def _wide(g, value_mode, seed=4):
    """Uniform scatter, 4096 rows of 64 nonzeros over 2.5M columns, with
    values the packers store as ``value_mode``."""
    j = g.random_uniform(4096, 2_500_000, 64, dtype=np.float32, seed=seed)
    rng = np.random.default_rng(seed)
    if value_mode in ("df16", "palette_df"):
        v = (rng.standard_normal(7)[rng.integers(0, 7, j.nnz)]
             if value_mode == "palette_df" else rng.standard_normal(j.nnz))
        return g.CsrMatrix(j.m, j.n, j.rowptr, j.colidx, v)
    if value_mode == "palette":
        return j
    v = rng.integers(1, 256, j.nnz) / 32.0
    return g.CsrMatrix(j.m, j.n, j.rowptr, j.colidx, v.astype(np.float32))


def test_stripe_constants_and_bounds_identical():
    assert (t_8d.MAX_STRIPES, t_8d.MAX_SPILL_STRIPED, t_8d.STRIPE_ALIGN) \
        == (j_8d.MAX_STRIPES, j_8d.MAX_SPILL_STRIPED, j_8d.STRIPE_ALIGN)
    for n in (1_000_000, 2_000_000, 2_000_001, 2_500_000, 4_000_000,
              9_999_999, 128_000_000, 200_000_000):
        assert t_8d.column_stripe_bounds(n) == j_8d.column_stripe_bounds(n)
        assert t_8d.stripe_overhead_ns(n) == j_8d.stripe_overhead_ns(n)
    rng = np.random.default_rng(3)
    for windowed in (False, True):
        for _ in range(20):
            tiles = rng.integers(0, 300, rng.integers(1, 40))
            assert (t_8d._choose_g(tiles, 20.0, windowed)
                    == j_8d._choose_g(tiles, 20.0, windowed))


@pytest.mark.parametrize("value_mode,nw", [("bf16", 8), ("palette", 4),
                                           ("df16", 8), ("palette_df", 2)])
def test_pack_sell8d_striped_identical(value_mode, nw):
    # stripe by stripe: (lo, hi, vis), meta, values, tinfo, ginfo rebased
    # to vis, and the merged rest with global columns
    j, t = _wide(j_gen, value_mode), _wide(t_gen, value_mode)
    _same((j.rowptr, j.colidx, j.vals), (t.rowptr, t.colidx, t.vals))
    sj, rj, pj = j_8d.pack_sell8d_striped(j, max_pad_ratio=64.0, nw=nw,
                                          cell_w=nw > 1)
    st, rt, pt = t_8d.pack_sell8d_striped(t, max_pad_ratio=64.0, nw=nw,
                                          cell_w=nw > 1)
    assert len(st) == 2 and pt == pj
    assert {q[3].value_mode for q in st} == {value_mode}
    _same(sj, st)
    _same(rj, rt)
    for windowed in (False, True):
        for w in (None, nw):
            assert (j_8d.estimate_sell8d_auto(
                j, nw=w, windowed=windowed, max_spill=j_8d.MAX_SPILL_STRIPED)
                == t_8d.estimate_sell8d_auto(
                t, nw=w, windowed=windowed,
                max_spill=t_8d.MAX_SPILL_STRIPED))


@pytest.mark.parametrize("value_mode,nw", [("palette", 1), ("bf16", 2),
                                           ("df16", 1), ("palette_df", 2)])
def test_windowed_pack_sell8d_identical(value_mode, nw):
    # one slot stream past 2M columns: the windowed cost table and g
    j, t = _wide(j_gen, value_mode, seed=5), _wide(t_gen, value_mode, seed=5)
    kw = dict(g="auto", max_pad_ratio=256.0, max_spill=0.05, nw=nw,
              cell_w=nw > 1)
    pj, rj = j_8d.pack_sell8d(j, **kw)
    pt, rt = t_8d.pack_sell8d(t, **kw)
    assert pt.n > 2_000_000 and pt.value_mode == value_mode
    assert pt.g in (8, 16)
    _same(pj, pt)
    _same(rj, rt)


@pytest.mark.parametrize("f64", [False, True])
def test_pack_sell8w_and_plan_v2_identical_past_2m(f64):
    # SELL-8W at max_pad_ratio=8 (the windowed row allowance) and plan_v2,
    # f32 and the f64 double pack (hi, lo)
    j, t = _both(lambda g: g.clustered(4000, 2_500_000, 10, spread=400,
                                       dtype=np.float32, seed=3))
    if f64:
        j, t = _f64_values(j, t, "df16")

    def pack(mod, a, cls):
        hi = mod.pack_sell8w(a, max_pad_ratio=1e9)
        if not f64:
            return hi, mod.plan_v2(hi)
        lo = mod.pack_sell8w(cls(a.m, a.n, a.rowptr, a.colidx,
                                 (a.vals - a.vals.astype(np.float32))
                                 .astype(np.float32)))
        return hi, mod.plan_v2(hi, lo_tiles=lo.vals)

    (hj, vj), (ht, vt) = pack(j_8w, j, JaxCsr), pack(t_8w, t, TorchCsr)
    assert vt.n > 2_000_000
    assert vt.value_mode == ("df16" if f64 else "palette")
    _same(hj, ht)
    _same(vj, vt)
    assert j_8w.estimate_sell8w_tiles(j) == t_8w.estimate_sell8w_tiles(t)
    with pytest.raises(ValueError):
        t_8w.pack_sell8w(t, max_pad_ratio=1.0)


def _float(j, t, dtype):
    """Both packages' matrices with random values of ``dtype``."""
    v = np.random.default_rng(13).standard_normal(j.nnz).astype(dtype)
    return (JaxCsr(j.m, j.n, j.rowptr, j.colidx, v),
            TorchCsr(t.m, t.n, t.rowptr, t.colidx, v))


#: the scan plans' matrices: power-law rows (mega-rows past every tile),
#: empty rows, a single row
_SCAN_MATRICES = {
    "powerlaw": lambda g: g.power_law(3000, 3000, 60_000, seed=2),
    "empty_rows": lambda g: g.with_empty_rows(
        g.random_uniform(2000, 1500, 6, seed=3), 0.4),
    "one_row": lambda g: g.random_uniform(1, 5000, 3000, seed=4),
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(_SCAN_MATRICES))
def test_scan_plans_identical(name, dtype):
    from spmv_tpu.formats import partition as j_part
    from spmv_tpu_torch.formats import partition as t_part
    j, t = _float(*_both(_SCAN_MATRICES[name]), dtype)
    _same(j_part.row_ids(j), t_part.row_ids(t))
    for tile in (256, 1024, 4096):
        _same(j_part.build_tile_scan_plan(j, tile=tile),
              t_part.build_tile_scan_plan(t, tile=tile))
        pj = j_part.build_balanced2_plan(j, tile=tile)
        pt = t_part.build_balanced2_plan(t, tile=tile)
        assert (pj is None) == (pt is None)
        if pj is not None:
            _same(pj, pt)
    arr = np.arange(10, dtype=dtype)
    _same(j_part.pad_stream(arr, 8, dtype(0)),
          t_part.pad_stream(arr, 8, dtype(0)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("sigma", [1, 32 * 128])
def test_pack_sell_identical(sigma, dtype):
    from spmv_tpu.formats import sell as j_sell
    from spmv_tpu_torch.formats import sell as t_sell
    for make in (_SCAN_MATRICES["empty_rows"],
                 lambda g: g.power_law(3000, 2500, 30_000, seed=5)):
        j, t = _float(*_both(make), dtype)
        _same(j_sell.pack_sell(j, sigma=sigma), t_sell.pack_sell(t, sigma=sigma))


def _community(g, seed=0, ncomm=6, size=300, within=8):
    """test_locality.py's shuffled communities: block structure RCM cannot
    see."""
    rng = np.random.default_rng(seed)
    m = ncomm * size
    shuffle = rng.permutation(m)
    rows = np.concatenate([rng.integers(c * size, (c + 1) * size,
                                        size * within)
                           for c in range(ncomm)] + [rng.integers(0, m, 200)])
    cols = np.concatenate([rng.integers(c * size, (c + 1) * size,
                                        size * within)
                           for c in range(ncomm)] + [rng.integers(0, m, 200)])
    return g.CsrMatrix.from_coo(m, m, shuffle[rows], shuffle[cols],
                                g.exact_values(rng, rows.size))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["community", "scrambled_band", "powerlaw"])
def test_reorder_identical(name, dtype):
    from spmv_tpu.formats import reorder as j_re
    from spmv_tpu_torch.formats import reorder as t_re

    def make(g):
        if name == "community":
            return _community(g)
        if name == "powerlaw":
            return g.power_law(2000, 2000, 30_000, seed=6)
        a = g.banded(1500, 1500, 3, seed=2)
        mod = j_re if g is j_gen else t_re
        return mod.reorder_symmetric(
            a, np.random.default_rng(1).permutation(1500))[0]

    j, t = _float(*_both(make), dtype)
    assert j_re.bandwidth(j) == t_re.bandwidth(t)
    for fn, kw in (("rcm_order", {}), ("window_cluster_order", {}),
                   ("window_cluster_order", {"window": 256,
                                             "row_block": 128}),
                   ("label_propagation_clusters", {}),
                   ("label_propagation_clusters", {"min_cluster": 64}),
                   ("cluster_order", {}), ("length_order", {})):
        pj = getattr(j_re, fn)(j, **kw)
        pt = getattr(t_re, fn)(t, **kw)
        _same(pj, pt)
    _same(j_re.cluster_split(j, 4), t_re.cluster_split(t, 4))
    perm = t_re.rcm_order(t)
    _same(j_re.reorder_symmetric(j, perm), t_re.reorder_symmetric(t, perm))
    _same(j_re.reorder_rows(j, perm), t_re.reorder_rows(t, perm))
