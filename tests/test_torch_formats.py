"""The port's host layer (jax-free copies in spmv_tpu_torch) pinned to the
JAX package's originals: generators, packers (bit-identical arrays, bf16
compared as its uint16 bits), the numpy bf16 conversion, and the AUTO
method choice."""

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
