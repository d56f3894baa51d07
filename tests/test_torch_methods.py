"""Every method of the port against the JAX package's plan, mirroring
tests/test_methods.py and tests/test_balanced2.py: the structural zoo of
tests/conftest.py through ``create_handle(..., device="cpu")``, the plan
held to the JAX planner's (TPU gate on) array for array, and the result to
the JAX plan's.  The JAX plan runs as the JAX package runs it on the CPU:
its XLA plans (Serial, the scans, Balanced2, the chunked SELL, BCSR)
directly, its Pallas plans in interpret mode (``_reference_exec``).  Also
BCSR and the MXU rung, ``reorder=``, and the SELL ladder's fall-through to
the chunked SELL and on to the tiled scan.

Tolerances:
- dyadic values and x = 1 (f32 and f64): the port equals the JAX plan and
  the golden product bit for bit;
- random values, per row against (|A||x|)_i: f32 1e-5, plus for the f32
  scans the absolute term of tests/test_methods.py, 1e-4·max(max|y|, 1):
  their f32 prefix sums carry about eps·sqrt(nnz) absolute error, which
  no row's (|A||x|)_i bounds;
- f64: 1e-12 against the JAX plan where it runs in true f64 (its XLA
  plans); a SELL or COO2 plan runs in interpret mode, whose double-float
  arithmetic XLA:CPU simplifies to about f32 accuracy, so there the port is
  held to row-by-row f64 sums at 1e-10 (df16 values carry ≤ 2^-39
  relative error) and to the interpret-mode plan at 2e-6.
"""

import numpy as np
import pytest
import torch

import spmv_tpu.handle as jh
from spmv_tpu.formats import reorder as j_reorder
from spmv_tpu.io import generate as j_gen
from spmv_tpu.types import Method as JMethod, VectorizedWay as JVec
import spmv_tpu_torch as st
from spmv_tpu_torch import handle as th
from spmv_tpu_torch.convert import plan_from_reference
from spmv_tpu_torch.formats import reorder as t_reorder
from spmv_tpu_torch.io import generate as t_gen
from test_torch_handle import _reference_exec, _same_placed

METHODS = [st.Method.SERIAL, st.Method.PARALLEL, st.Method.BALANCED,
           st.Method.BALANCED2, st.Method.BALANCED_YID,
           st.Method.SELL_C_SIGMA, st.Method.CSR5, st.Method.AUTO]
VECTORIZED = [st.VectorizedWay.VPU, st.VectorizedWay.NONE]
#: plan keys of the plans the JAX package runs through Pallas
_PALLAS = ("graph", "hybrid", "sell8d", "sell8d_stripes", "sell8w_v2",
           "sell8w_v2w", "coo2", "dia_pallas")
#: plan kinds whose f32 sums are prefix sums
_SCANS = ("scan", "balanced2")


@pytest.fixture(autouse=True)
def tpu_gate(monkeypatch):
    """The JAX planner routes as it does on a TPU."""
    monkeypatch.setattr(jh, "_is_tpu", lambda: True)


def _port(a):
    return st.CsrMatrix(a.m, a.n, a.rowptr, a.colidx, a.vals)


def _pallas(plan):
    return any(k in plan for k in _PALLAS)


def _run_reference(jhandle, x):
    """The JAX handle's result on the CPU, in f64."""
    if not _pallas(jhandle.plan):
        return np.asarray(jh.spmv(jhandle, x), dtype=np.float64)
    perm = jhandle.perm
    y = _reference_exec(jhandle.plan, x if perm is None else x[perm],
                        jhandle.m)
    if perm is None:
        return y
    out = np.empty_like(y)
    out[perm] = y
    return out


def _rowwise(a, x):
    """(row-by-row f64 sums, (|A||x|)_i) of ``a`` at ``x``."""
    rows = np.repeat(np.arange(a.m), a.row_lengths)
    prod = np.asarray(a.vals, np.float64) * np.asarray(x, np.float64)[
        a.colidx]
    y, absax = np.zeros(a.m), np.zeros(a.m)
    np.add.at(y, rows, prod)
    np.add.at(absax, rows, np.abs(prod))
    return y, absax + 1e-300


def _pair(a, method, vectorized=st.VectorizedWay.VPU, reorder=None):
    """The port's handle and the JAX package's for ``a``: the same
    resolved method and the same plan."""
    h = st.create_handle(_port(a), method=method, vectorized=vectorized,
                         reorder=reorder, device="cpu")
    jhandle = jh.create_handle(a, method=JMethod(int(method)),
                               vectorized=JVec(int(vectorized)),
                               reorder=reorder)
    assert int(h.method) == int(jhandle.method)
    assert h.requested_method == method
    _same_placed(h.plan, plan_from_reference(jhandle.plan, "cpu"))
    return h, jhandle


def _y(h, x):
    return st.spmv(h, torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("vectorized", VECTORIZED, ids=lambda v: v.name)
@pytest.mark.parametrize("method", METHODS, ids=lambda m: m.name)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_method_exact_arithmetic(matrices, method, vectorized, dtype):
    """Dyadic values + x = 1: the port, the JAX plan and the golden
    product agree bit for bit (test_methods.py's gate)."""
    for name, a in matrices.items():
        a = a.astype(dtype)
        h, jhandle = _pair(a, method, vectorized)
        x = np.ones(a.n, dtype=dtype)
        y = _y(h, x)
        assert y.dtype == dtype, name
        g = st.spmv_golden(_port(a).astype(np.float64), x.astype(np.float64))
        np.testing.assert_array_equal(y, g.astype(dtype),
                                      err_msg=f"{name}/{method.name}")
        np.testing.assert_array_equal(
            y, _run_reference(jhandle, x).astype(dtype),
            err_msg=f"{name}/{method.name}")


@pytest.mark.parametrize("vectorized", VECTORIZED, ids=lambda v: v.name)
@pytest.mark.parametrize("method", METHODS, ids=lambda m: m.name)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_method_random_values(matrices, method, vectorized, dtype):
    rng = np.random.default_rng(0)
    for name, a in matrices.items():
        a = type(a)(a.m, a.n, a.rowptr, a.colidx,
                    rng.standard_normal(a.nnz).astype(dtype))
        h, jhandle = _pair(a, method, vectorized)
        x = rng.standard_normal(a.n).astype(dtype)
        y = _y(h, x)
        exact, absax = _rowwise(a, x)
        y_ref = _run_reference(jhandle, x)
        msg = f"{name}/{method.name}/{th.plan_kind(h.plan)}"
        if dtype == np.float32:
            bound = 1e-5 * absax
            if th.plan_kind(h.plan) in _SCANS:
                bound = bound + 1e-4 * max(np.abs(exact).max(), 1.0)
            np.testing.assert_array_less(np.abs(y - exact), bound, msg)
            np.testing.assert_array_less(np.abs(y - y_ref), bound, msg)
        elif _pallas(jhandle.plan):
            np.testing.assert_array_less(np.abs(y - exact), 1e-10 * absax,
                                         msg)
            np.testing.assert_array_less(np.abs(y - y_ref), 2e-6 * absax,
                                         msg)
        else:
            np.testing.assert_array_less(np.abs(y - y_ref), 1e-12 * absax,
                                         msg)
            np.testing.assert_array_less(np.abs(y - exact), 1e-12 * absax,
                                         msg)


def test_parity_constructor_balanced():
    # test_methods.py's test_parity_constructor: nthreads reaches the
    # tile choice
    a = t_gen.banded(50, 50, 2)
    h = st.spmv_create_handle_all_in_one(
        a.m, a.n, a.rowptr, a.colidx, a.vals, nthreads=8,
        method=st.Method.BALANCED, dtype=np.float64, mtx_token="banded50",
        device="cpu")
    assert h.method_name == "Method_Balanced" and h.mtx_token == "banded50"
    assert h.plan["tile"] == jh._tile_for(a.nnz, 8, JMethod.BALANCED) == 256
    x = np.ones(a.n)
    np.testing.assert_array_equal(_y(h, x), st.spmv_golden(a, x))


# -- Balanced2 (tests/test_balanced2.py) ------------------------------------

def _megarow_matrix(g, m=300, n=50_000, mega_nnz=20_000, seed=0):
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.zeros(mega_nnz, dtype=np.int64),
                           rng.integers(1, m, size=2000)])
    cols = rng.integers(0, n, size=rows.size)
    vals = g.exact_values(rng, rows.size)
    return g.CsrMatrix.from_coo(m, n, rows, cols, vals)


def _check_balanced2(ja, x, kind):
    h, jhandle = _pair(ja, st.Method.BALANCED2)
    assert th.plan_kind(h.plan) == kind
    y = _y(h, x)
    exact, absax = _rowwise(ja, x)
    np.testing.assert_array_less(np.abs(y - exact), 1e-12 * absax)
    np.testing.assert_array_less(np.abs(y - _run_reference(jhandle, x)),
                                 1e-12 * absax)
    return h


def test_balanced2_megarow_builds_distinct_plan():
    ja = _megarow_matrix(j_gen)
    x = j_gen.make_x(ja.n, np.float64, kind="normal", seed=1)
    h = _check_balanced2(ja, x, "balanced2")
    assert h.method == st.Method.BALANCED2
    assert h.plan["n_mega_rows"] >= 1 and h.plan["m_virtual"] > ja.m
    hb = st.create_handle(_port(ja), method=st.Method.BALANCED,
                          device="cpu")
    assert set(h.plan) != set(hb.plan)
    np.testing.assert_allclose(_y(hb, x), _y(h, x), rtol=1e-9)


def test_balanced2_demotes_without_megarows():
    ja = j_gen.banded(3000, 3000, 3, dtype=np.float64, seed=2)
    x = j_gen.make_x(ja.n, np.float64, kind="normal", seed=3)
    h = _check_balanced2(ja, x, "scan")
    assert h.requested_method == st.Method.BALANCED2
    assert h.method == st.Method.BALANCED            # demoted, visibly
    hb = st.create_handle(_port(ja), method=st.Method.BALANCED,
                          device="cpu")
    assert set(h.plan) == set(hb.plan) and "demoted" not in h.plan


def test_balanced2_empty_rows_and_tiny():
    ja = j_gen.with_empty_rows(_megarow_matrix(j_gen, seed=7), 0.3, seed=8)
    x = j_gen.make_x(ja.n, np.float64, kind="normal", seed=9)
    _check_balanced2(ja, x, "balanced2")
    tiny = j_gen.banded(3, 3, 1)
    _check_balanced2(tiny, np.ones(3), "scan")


# -- BCSR and the MXU rung --------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bcsr_method(dtype):
    ja = j_gen.block_random(6, 8, blocks_per_row=3, fill=0.4, seed=2,
                            dtype=dtype)
    h, jhandle = _pair(ja, st.Method.BCSR)
    assert th.plan_kind(h.plan) == "bcsr"
    assert h.plan["blocks"].dtype == (torch.float64 if dtype == np.float64
                                      else torch.bfloat16)  # lossless bf16
    x = np.random.default_rng(1).standard_normal(ja.n).astype(dtype)
    y = _y(h, x)
    exact, absax = _rowwise(ja, x)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    np.testing.assert_array_less(np.abs(y - exact), tol * absax)
    np.testing.assert_array_less(np.abs(y - _run_reference(jhandle, x)),
                                 tol * absax)
    # random values: f32 blocks, summed in f32
    jr = type(ja)(ja.m, ja.n, ja.rowptr, ja.colidx,
                  np.random.default_rng(3).standard_normal(ja.nnz)
                  .astype(dtype))
    h, jhandle = _pair(jr, st.Method.BCSR)
    exact, absax = _rowwise(jr, x)
    np.testing.assert_array_less(np.abs(_y(h, x) - exact), tol * absax)
    np.testing.assert_array_less(
        np.abs(_y(h, x) - _run_reference(jhandle, x)), tol * absax)


def test_bcsr_refuses_scattered():
    ja = j_gen.random_uniform(2000, 2000, 8, dtype=np.float32, seed=3)
    with pytest.raises(ValueError, match="BCSR unprofitable"):
        st.create_handle(_port(ja), method=st.Method.BCSR, device="cpu")
    with pytest.raises(ValueError, match="BCSR unprofitable"):
        jh.create_handle(ja, method=JMethod.BCSR)


def test_auto_picks_bcsr_for_blocky():
    ja = j_gen.block_random(4, 4, blocks_per_row=2, fill=0.5, seed=3)
    h, _ = _pair(ja, st.Method.AUTO)
    assert h.method == st.Method.BCSR and th.plan_kind(h.plan) == "bcsr"


@pytest.mark.parametrize("method", [st.Method.PARALLEL,
                                    st.Method.SELL_C_SIGMA,
                                    st.Method.CSR5])
def test_mxu_rung(method):
    # VectorizedWay.MXU takes BCSR where the blocks are dense enough, and
    # the ordinary plan where they are not
    ja = j_gen.block_random(3, 5, blocks_per_row=2, fill=0.3, seed=4,
                            dtype=np.float32)
    h, jhandle = _pair(ja, method, st.VectorizedWay.MXU)
    assert h.method == st.Method.BCSR and h.requested_method == method
    x = np.ones(ja.n, np.float32)
    np.testing.assert_array_equal(_y(h, x),
                                  _run_reference(jhandle, x)
                                  .astype(np.float32))
    scattered = j_gen.random_uniform(2000, 2000, 8, dtype=np.float32,
                                     seed=3)
    h, _ = _pair(scattered, method, st.VectorizedWay.MXU)
    assert h.method == method


def test_bcsr_profile_and_rect():
    from spmv_tpu_torch.formats.bcsr import bcsr_profile, pack_bcsr
    a = t_gen.block_random(3, 5, blocks_per_row=2, fill=0.3, seed=4)
    nb, fill = bcsr_profile(a)
    assert nb <= 6 and fill > 0.2
    b = pack_bcsr(a)
    dense = np.zeros((a.m, a.n), np.float32)
    for k in range(b.nblocks):
        r0, c0 = b.block_rows[k] * 128, b.block_cols[k] * 128
        dense[r0:r0 + 128, c0:c0 + 128] = b.blocks[k]
    np.testing.assert_allclose(dense, a.to_dense().astype(np.float32))
    h = st.create_handle(a, method=st.Method.BCSR, device="cpu")
    x = np.random.default_rng(5).standard_normal(a.n)
    exact, absax = _rowwise(a, x)
    np.testing.assert_array_less(np.abs(_y(h, x) - exact), 1e-12 * absax)


# -- reorder= (tests/test_methods.py, tests/test_locality.py) ---------------

def test_handle_reorder_rcm():
    ja0 = j_gen.banded(256, 256, 3, seed=2)
    scramble = np.random.default_rng(1).permutation(256)
    ja, _ = j_reorder.reorder_symmetric(ja0, scramble)
    h, jhandle = _pair(ja, st.Method.BALANCED, reorder="rcm")
    assert h.perm is not None
    assert np.array_equal(h.perm, jhandle.perm)
    x = np.random.default_rng(2).standard_normal(ja.n)
    exact, absax = _rowwise(ja, x)
    y = _y(h, x)
    np.testing.assert_array_less(np.abs(y - exact), 1e-12 * absax)
    np.testing.assert_array_less(np.abs(y - _run_reference(jhandle, x)),
                                 1e-12 * absax)
    # AUTO after the reorder finds the band again: DIA
    h, jhandle = _pair(ja, st.Method.AUTO, reorder="rcm")
    assert h.method == st.Method.DIA
    np.testing.assert_array_less(np.abs(_y(h, x) - exact), 1e-12 * absax)
    np.testing.assert_array_less(
        np.abs(_y(h, x) - _run_reference(jhandle, x)), 2e-6 * absax)


def test_handle_reorder_rejects_rect():
    a = t_gen.random_uniform(50, 70, 4, seed=1)
    with pytest.raises(ValueError):
        st.create_handle(a, method=st.Method.SERIAL, reorder="rcm",
                         device="cpu")
    with pytest.raises(ValueError, match="unknown reorder"):
        st.create_handle(t_gen.banded(50, 50, 2), reorder="metis",
                         device="cpu")


@pytest.mark.parametrize("kind", ["rcm", "window", "cluster", "length"])
def test_handle_reorder_kinds(kind):
    # every reorder kind under AUTO: the JAX planner's permutation and
    # plan, the result against row-by-row sums
    ja = j_gen.random_uniform(3000, 3000, 9, dtype=np.float32, seed=11)
    h, jhandle = _pair(ja, st.Method.AUTO, reorder=kind)
    assert np.array_equal(h.perm, jhandle.perm)
    x = np.random.default_rng(4).standard_normal(ja.n).astype(np.float32)
    y = _y(h, x)
    exact, absax = _rowwise(ja, x)
    np.testing.assert_array_less(np.abs(y - exact), 1e-5 * absax)
    np.testing.assert_array_less(np.abs(y - _run_reference(jhandle, x)),
                                 1e-5 * absax)


def test_cluster_reorder_handle():
    # test_locality.py's test_cluster_reorder_handle_correctness
    from test_locality import _shuffled_communities
    ja = _shuffled_communities(ncomm=4, size=150, within=6, seed=1)
    h, jhandle = _pair(ja, st.Method.SERIAL, reorder="cluster")
    x = j_gen.make_x(ja.n, np.float32, kind="normal", seed=2)
    exact, absax = _rowwise(ja, x)
    y = _y(h, x)
    np.testing.assert_array_less(np.abs(y - exact), 1e-5 * absax)
    np.testing.assert_array_less(np.abs(y - _run_reference(jhandle, x)),
                                 1e-5 * absax)


def test_cached_order(tmp_path):
    # the on-disk cache: the JAX package's file name and fingerprint, so
    # either package reads the other's permutation
    a = t_gen.banded(300, 300, 4, seed=3)
    ja = j_gen.banded(300, 300, 4, seed=3)
    p1 = t_reorder.cached_order(a, "tok", kind="rcm", cache_dir=str(tmp_path))
    files = sorted(f.name for f in tmp_path.iterdir())
    p2 = j_reorder.cached_order(ja, "tok", kind="rcm",
                                cache_dir=str(tmp_path))
    assert sorted(f.name for f in tmp_path.iterdir()) == files
    assert np.array_equal(p1, p2)
    np.savez(tmp_path / files[0], **{**np.load(tmp_path / files[0]),
                                     "perm": p1[::-1]})
    assert np.array_equal(t_reorder.cached_order(
        a, "tok", kind="rcm", cache_dir=str(tmp_path)), p1[::-1])


def test_handle_reorder_with_token(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    a = t_gen.banded(400, 400, 3, seed=5)
    h = st.create_handle(a, reorder="rcm", mtx_token="band400",
                         device="cpu")
    assert (tmp_path / "cache").is_dir()
    assert np.array_equal(h.perm, t_reorder.rcm_order(a))
    h.prepare(st.Method.BALANCED)
    assert h.method == st.Method.BALANCED and h.perm is not None
    x = np.random.default_rng(6).standard_normal(a.n)
    exact, absax = _rowwise(a, x)
    np.testing.assert_array_less(np.abs(_y(h, x) - exact), 1e-12 * absax)


# -- the SELL ladder's fall-through -----------------------------------------

#: name → (generator call, method, the plan the JAX planner builds)
FALL_THROUGH = {
    # n = 1M over 2,048 rows of ~4: every window and slot layout pads past
    # its gate and the graph split finds nothing; the chunked SELL pads ~3
    "scattered_chunked": (lambda g: g.random_uniform(
        2048, 1_000_000, 4, dtype=np.float32, seed=5),
        st.Method.SELL_C_SIGMA, "chunked-sell"),
    # the same through Method.CSR5: the pass-2 gate refuses, no SELL tile
    # plan fits, the tiled scan
    "scattered_csr5": (lambda g: g.random_uniform(
        2048, 1_000_000, 4, dtype=np.float32, seed=5),
        st.Method.CSR5, "scan"),
    # 3 rows: the chunked SELL's 128-row slice pads past 8 as well, so the
    # tiled scan (sell_fallback)
    "tiny_scan": (lambda g: g.banded(3, 3, 1, dtype=np.float32),
                  st.Method.SELL_C_SIGMA, "scan"),
}


@pytest.mark.parametrize("name", sorted(FALL_THROUGH))
def test_sell_ladder_fall_through(name):
    make, method, kind = FALL_THROUGH[name]
    ja = make(j_gen)
    h, jhandle = _pair(ja, method)
    assert th.plan_kind(h.plan) == kind
    assert not _pallas(jhandle.plan)
    if name == "tiny_scan":
        assert h.plan["sell_fallback"] == "scan"
    x = np.random.default_rng(8).standard_normal(ja.n).astype(np.float32)
    y = _y(h, x)
    exact, absax = _rowwise(ja, x)
    bound = 1e-5 * absax
    if kind == "scan":
        bound = bound + 1e-4 * max(np.abs(exact).max(), 1.0)
    np.testing.assert_array_less(np.abs(y - exact), bound)
    np.testing.assert_array_less(np.abs(y - _run_reference(jhandle, x)),
                                 bound)
