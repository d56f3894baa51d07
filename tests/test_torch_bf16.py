"""bf16 matrices in the port against the JAX package (tests/test_methods.py's
test_bfloat16_storage, tests/test_types_io.py's test_bfloat16_end_to_end).

The same matrices, made from numpy seeds by the JAX generators and cast
with ``astype(ml_dtypes.bfloat16)``, go through the JAX package (TPU gate
on, its Pallas DIA kernel in interpret mode) and through the port on
``device="cpu"``, whose ``CsrMatrix`` takes the ``ml_dtypes`` array as its
uint16 bits.

Held:
- ``CsrMatrix``: ``astype(torch.bfloat16)`` bit for bit as
  ``astype(ml_dtypes.bfloat16)``; a ``torch.bfloat16`` tensor, an
  ``ml_dtypes`` array and bits give one matrix, whose ``dtype`` reads
  ``torch.bfloat16``, never uint16;
- every method (and AUTO, ``reorder="rcm"``, ``VectorizedWay.NONE`` and
  ``MXU``): the JAX planner's resolved method and plan, its packs bit for
  bit (bf16 compared as placed ``torch.bfloat16`` tensors), y in f32; at
  x = 1 on dyadic values y equals the golden product and the JAX plan bit
  for bit; at a random x y is within 1e-5·(|A||x|)_i of both, plus for
  the scans the absolute term of tests/test_torch_methods.py,
  1e-4·max(max|y|, 1) (f32 prefix sums);
- values in [-3, 3], whose bits read as integers are not the values,
  through every method and the mesh plans: no path reads the bits as
  numbers;
- the mesh: the scan in three x modes and DIA, packs bit for bit and y
  within the bounds above of the JAX plan; the SELL builders raise the
  JAX builders' ``ValueError``; ``build_dist_auto`` takes the JAX kind
  (the scan) and x mode;
- the tools: ``tune`` rounds its x to bf16 as the JAX tuner does, the
  suite writes bf16 rows (rmse < 1e-4), ``load_matrix`` and ``read_mtx``
  give the JAX package's bits, the solvers run on a bf16 handle.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import spmv_tpu.handle as jh
from spmv_tpu import parallel as jpar
from spmv_tpu.io import generate as j_gen
from spmv_tpu.io import mmio as j_mmio
from spmv_tpu.formats import reorder as j_reorder
from spmv_tpu.types import CsrMatrix as JaxCsr
from spmv_tpu.types import Method as JMethod, VectorizedWay as JVec
import spmv_tpu_torch as st
from spmv_tpu_torch import convert, handle as th, parallel as tpar
from spmv_tpu_torch.formats import _bf16
from spmv_tpu_torch.io import mmio
from test_torch_dist import _assert_same_pack
from test_torch_handle import _same_placed
from test_torch_methods import _SCANS, _run_reference

BF16 = ml_dtypes.bfloat16
METHODS = list(st.Method)


@pytest.fixture(autouse=True)
def tpu_gate(monkeypatch):
    """The JAX planner routes as it does on a TPU."""
    monkeypatch.setattr(jh, "_is_tpu", lambda: True)


def _bf(a):
    """The JAX matrix with its values rounded to bf16."""
    return a.astype(BF16)


def _port(a):
    return st.CsrMatrix(a.m, a.n, a.rowptr, a.colidx, a.vals)


def _wide(a, seed=3):
    """``a``'s pattern with values in [-3, 3] rounded to bf16: their bits,
    read as integers, are not their values."""
    v = np.random.default_rng(seed).uniform(-3.0, 3.0, a.nnz)
    return JaxCsr(a.m, a.n, a.rowptr, a.colidx, v.astype(BF16))


#: name → the JAX generator call (dyadic values k/8)
GENERATORS = {
    "band": lambda: j_gen.banded(3000, 3000, 3, seed=1),
    "uniform": lambda: j_gen.random_uniform(3000, 3000, 9, seed=2),
    "clustered": lambda: j_gen.clustered(4000, 4000, 16, spread=256,
                                         seed=3),
    # past 10k nonzeros: AUTO's heavy-tail rungs (the hybrid hint, the
    # length sort), as on powerlaw100k
    "powerlaw": lambda: j_gen.power_law(10_000, 10_000, 400_000, seed=2),
    "webbase": lambda: j_gen.webbase_like(50_000, 50_000, 155_000,
                                          seed=11),
}


def _golden(a, x):
    """(row-by-row f64 sums of the decoded matrix, (|A||x|)_i)."""
    vals = np.asarray(a.vals, dtype=np.float64)
    rows = np.repeat(np.arange(a.m), a.row_lengths)
    prod = vals * np.asarray(x, np.float64)[a.colidx]
    y, absax = np.zeros(a.m), np.zeros(a.m)
    np.add.at(y, rows, prod)
    np.add.at(absax, rows, np.abs(prod))
    return y, absax + 1e-300


def _pair(a, method, vectorized=st.VectorizedWay.VPU, reorder=None):
    """The port's handle and the JAX package's for the bf16 matrix ``a``:
    the same resolved method and the same placed plan; None, None when
    both refuse it (DIA's or BCSR's "unprofitable")."""
    try:
        jhandle = jh.create_handle(a, method=JMethod(int(method)),
                                   vectorized=JVec(int(vectorized)),
                                   reorder=reorder)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split()[0]):
            st.create_handle(_port(a), method=method,
                             vectorized=vectorized, reorder=reorder,
                             device="cpu")
        return None, None
    h = st.create_handle(_port(a), method=method, vectorized=vectorized,
                         reorder=reorder, device="cpu")
    assert int(h.method) == int(jhandle.method)
    assert h.dtype == torch.bfloat16
    _same_placed(h.plan, convert.plan_from_reference(jhandle.plan, "cpu"))
    return h, jhandle


def _check(h, jhandle, a, x, exact=False):
    """y of the port's handle: f32, against row-by-row sums and the JAX
    plan, bit for bit when ``exact``."""
    y = st.spmv(h, torch.from_numpy(x)).numpy()
    assert y.dtype == np.float32 and y.shape == (a.m,)
    ref, absax = _golden(a, x)
    y_jax = _run_reference(jhandle, x)
    msg = f"{h.method.name}/{th.plan_kind(h.plan)}"
    if exact:
        np.testing.assert_array_equal(y, ref.astype(np.float32), msg)
        np.testing.assert_array_equal(y, y_jax.astype(np.float32), msg)
        return
    bound = 1e-5 * absax
    if th.plan_kind(h.plan) in _SCANS:
        bound = bound + 1e-4 * max(np.abs(ref).max(), 1.0)
    np.testing.assert_array_less(np.abs(y - ref), bound, msg)
    np.testing.assert_array_less(np.abs(y - y_jax), bound, msg)


# -- the matrix type ----------------------------------------------------------

@pytest.mark.parametrize("src", [np.float32, np.float64])
def test_astype_matches_ml_dtypes(src):
    # round to nearest even, ties both ways, an f64 input through f32 (as
    # ml_dtypes rounds it), subnormals, infinities and NaN
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.standard_normal(5000) * 10.0 ** rng.integers(
        -36, 36, 5000), [1 + 2 ** -8, 1 + 3 * 2 ** -8, 1 + 2 ** -8
                         + 2 ** -30, -0.0, 1e-40, np.inf, -np.inf,
                         np.nan]]).astype(src)
    a = JaxCsr(1, v.size, [0, v.size], np.arange(v.size), v)
    b = _port(a).astype(torch.bfloat16)
    want = v.astype(BF16).view(np.uint16)
    assert b.dtype == torch.bfloat16 and b.vals.dtype == np.uint16
    ok = ~np.isnan(v)
    np.testing.assert_array_equal(b.vals[ok], want[ok])
    assert np.isnan(_bf16.to_f32(b.vals[~ok])).all()
    np.testing.assert_array_equal(b.astype(np.float64).vals[ok],
                                  v.astype(BF16).astype(np.float64)[ok])


def test_bf16_inputs_are_one_matrix():
    a = j_gen.random_uniform(40, 50, 4, seed=1)
    j16 = _bf(a)
    from_ml = _port(j16)
    from_torch = st.CsrMatrix(a.m, a.n, a.rowptr, a.colidx,
                              torch.from_numpy(a.vals).to(torch.bfloat16))
    from_bits = st.CsrMatrix(a.m, a.n, a.rowptr, a.colidx,
                             j16.vals.view(np.uint16))
    for b in (from_ml, from_torch, from_bits, _port(a).astype(
            torch.bfloat16)):
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(b.vals, j16.vals.view(np.uint16))
    np.testing.assert_array_equal(from_ml.to_dense(),
                                  j16.to_dense().astype(np.float32))
    assert st.types.dtype_name(from_ml.dtype) == "bfloat16"
    assert st.spmv_golden(from_ml, np.ones(a.n)).dtype == np.float64
    # duplicates sum in f32 and round once; rows and columns as the JAX
    # from_coo sorts them
    rows, cols = np.array([2, 0, 2, 1]), np.array([1, 3, 1, 0])
    vals = np.array([1.5, 2.0, 0.25, -3.0], np.float32)
    t = st.CsrMatrix.from_coo(3, 4, rows, cols,
                              torch.from_numpy(vals).to(torch.bfloat16))
    j = JaxCsr.from_coo(3, 4, rows, cols, vals.astype(BF16))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.rowptr, j.rowptr)
    np.testing.assert_array_equal(t.colidx, j.colidx)
    np.testing.assert_array_equal(t.vals, j.vals.view(np.uint16))


def test_handle_api():
    a = _port(_bf(j_gen.banded(500, 500, 2, seed=4)))
    h = st.create_handle(a, method=st.Method.SERIAL, device="cpu",
                         warm=True)
    assert h.dtype == torch.bfloat16 and "dtype=bfloat16" in repr(h)
    x = np.random.default_rng(1).standard_normal(a.n).astype(np.float32)
    x16 = torch.from_numpy(x).to(torch.bfloat16)
    # a bf16 x upcasts exactly: the same y as its f32 values
    y16 = st.spmv(h, x16)
    assert y16.dtype == torch.float32
    assert torch.equal(y16, st.spmv(h, x16.float()))
    h2 = st.spmv_create_handle_all_in_one(
        a.m, a.n, a.rowptr, a.colidx, a.astype(np.float32).vals,
        method=st.Method.DIA, dtype=torch.bfloat16, device="cpu")
    assert h2.dtype == torch.bfloat16
    assert h2.plan["dia"].data.dtype == torch.bfloat16
    np.testing.assert_array_equal(st.spmv(h2, x16).numpy(),
                                  st.spmv(h, x16).numpy())
    h.clear()
    h.prepare(st.Method.BALANCED)
    assert h.dtype == torch.bfloat16 and th.plan_kind(h.plan) == "scan"


# -- every method ---------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS, ids=lambda m: m.name)
@pytest.mark.parametrize("gen", list(GENERATORS))
def test_method_matches_jax(gen, method):
    a = _bf(GENERATORS[gen]())
    h, jhandle = _pair(a, method)
    if h is None:
        return
    _check(h, jhandle, a, np.ones(a.n, np.float32), exact=True)
    x = np.random.default_rng(5).standard_normal(a.n).astype(np.float32)
    _check(h, jhandle, a, x)


#: the routes the JAX planner gives bf16 on these generators (f32 would
#: take DIA, SELL-8D, the hybrid and the graph plan)
AUTO_ROUTES = {"band": ("DIA", "dia"),
               "clustered": ("SELL_C_SIGMA", "chunked-sell"),
               "powerlaw": ("SELL_C_SIGMA", "scan"),
               "webbase": ("SELL_C_SIGMA", "scan")}


@pytest.mark.parametrize("gen", sorted(AUTO_ROUTES))
def test_auto_routes(gen):
    a = _bf(GENERATORS[gen]())
    h, _ = _pair(a, st.Method.AUTO)
    assert (h.method.name, th.plan_kind(h.plan)) == AUTO_ROUTES[gen]
    if gen in ("powerlaw", "webbase"):
        assert h.plan["sell_fallback"] == "scan"


@pytest.mark.parametrize("method", METHODS, ids=lambda m: m.name)
def test_values_unlike_their_bits(method):
    # every method on values whose bits are not their values, the band
    # (DIA's and BCSR's plans) and the power-law matrix (the scans, the
    # mega-row split)
    for gen in ("band", "powerlaw"):
        a = _wide(GENERATORS[gen]())
        h, jhandle = _pair(a, method)
        if h is None:
            continue
        x = np.random.default_rng(6).standard_normal(a.n).astype(
            np.float32)
        _check(h, jhandle, a, x)


@pytest.mark.parametrize("vectorized", [st.VectorizedWay.NONE,
                                        st.VectorizedWay.MXU],
                         ids=lambda v: v.name)
@pytest.mark.parametrize("method", [st.Method.PARALLEL,
                                    st.Method.SELL_C_SIGMA,
                                    st.Method.CSR5, st.Method.AUTO],
                         ids=lambda m: m.name)
def test_vectorized_ways(method, vectorized):
    # NONE and MXU: the plain plans, and BCSR's bf16 blocks where the
    # blocks are dense enough
    a = _bf(j_gen.block_random(3, 5, blocks_per_row=2, fill=0.3, seed=4))
    h, jhandle = _pair(a, method, vectorized)
    if vectorized == st.VectorizedWay.MXU and method != st.Method.AUTO:
        assert h.method == st.Method.BCSR
        assert h.plan["blocks"].dtype == torch.bfloat16
    _check(h, jhandle, a, np.ones(a.n, np.float32), exact=True)


@pytest.mark.parametrize("method", [st.Method.AUTO, st.Method.BALANCED])
def test_reorder_rcm(method):
    ja0 = j_gen.banded(2000, 2000, 3, seed=2)
    scramble = np.random.default_rng(1).permutation(ja0.m)
    a = _bf(j_reorder.reorder_symmetric(ja0, scramble)[0])
    h, jhandle = _pair(a, method, reorder="rcm")
    assert np.array_equal(h.perm, jhandle.perm)
    if method == st.Method.AUTO:
        assert h.method == st.Method.DIA         # the band, found again
    x = np.random.default_rng(2).standard_normal(a.n).astype(np.float32)
    _check(h, jhandle, a, x)


@pytest.mark.parametrize("pack", ["sell8w.pack_sell8w", "sell8d.pack_sell8d",
                                  "coo2.pack_coo2"])
def test_tile_packs_refuse_bf16(pack):
    # the tile packers read values as f32 or f64; no route hands them a
    # bf16 matrix, and a direct call is refused, not read as integers
    import importlib
    mod, fn = pack.split(".")
    a = _port(_bf(j_gen.clustered(2000, 2000, 8, spread=200, seed=6)))
    f = getattr(importlib.import_module(f"spmv_tpu_torch.formats.{mod}"),
                fn)
    with pytest.raises(ValueError, match="not bfloat16"):
        f(a)


def test_dyadic_band_bf16_equals_f32_handle():
    # a dyadic band's f32 plan already streams lossless bf16 diagonals:
    # the bf16 matrix gives the same plan, bytes and y bit for bit
    a32 = st.CsrMatrix(*(lambda j: (j.m, j.n, j.rowptr, j.colidx,
                                    j.vals.astype(np.float32)))(
        GENERATORS["band"]()))
    h32 = st.create_handle(a32, device="cpu")
    h16 = st.create_handle(a32.astype(torch.bfloat16), device="cpu")
    assert h16.method == h32.method == st.Method.DIA
    _same_placed(h16.plan, h32.plan)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(a32.n)
                         .astype(np.float32))
    assert torch.equal(st.spmv(h16, x), st.spmv(h32, x))


# -- the mesh plans ---------------------------------------------------------------

def _dist_check(jplan, tplan, a, x):
    y = tplan(torch.from_numpy(x))
    assert y.dtype == torch.float32
    y = y.numpy().astype(np.float64)
    ref, absax = _golden(a, x)
    bound = 1e-5 * absax
    if isinstance(tplan, tpar.DistSpmvPlan) or getattr(
            tplan, "kind", None) == "scan":
        bound = bound + 1e-4 * max(np.abs(ref).max(), 1.0)
    np.testing.assert_array_less(np.abs(y - ref), bound)
    np.testing.assert_array_less(
        np.abs(y - np.asarray(jplan(x), dtype=np.float64)), bound)


@pytest.mark.parametrize("x_mode", ["replicated", "allgather", "halo"])
@pytest.mark.parametrize("kind", ["scan", "dia"])
def test_dist_plans(kind, x_mode):
    base = j_gen.banded(4000, 4000, 4, seed=1)
    x = np.random.default_rng(4).standard_normal(base.n).astype(np.float32)
    for a in (_bf(base), _wide(base)):
        if kind == "scan":
            jplan = jpar.build_dist_plan(a, jpar.make_mesh_1d(4), tile=256,
                                         x_mode=x_mode)
            static, arrays = (
                tpar.mesh._pack_scan_halo(_port(a), 4, 256, 1)
                if x_mode == "halo"
                else tpar.mesh._pack_scan(_port(a), 4, 256, x_mode))
            tplan = tpar.build_dist_plan(
                _port(a), tpar.make_mesh_1d(4, device="cpu"), tile=256,
                x_mode=x_mode)
            assert tplan.vals_pad[0].dtype == torch.bfloat16
        else:
            jplan = jpar.build_dist_dia_plan(a, jpar.make_mesh_1d(4),
                                             x_mode=x_mode)
            static, arrays = tpar.mesh._pack_dia(_port(a), 4, x_mode)
            tplan = tpar.build_dist_dia_plan(
                _port(a), tpar.make_mesh_1d(4, device="cpu"),
                x_mode=x_mode)
            assert tplan.data[0].dtype == torch.bfloat16
        _assert_same_pack(jplan, static, arrays)
        _dist_check(jplan, tplan, a, x)
        # the port's executor on the JAX plan's own arrays
        y_ref = convert.dist_plan_from_reference(
            jplan, tpar.make_mesh_1d(4, device="cpu"))(torch.from_numpy(x))
        assert torch.equal(y_ref, tplan(torch.from_numpy(x)))


@pytest.mark.parametrize("builder", ["build_dist_sell8w_plan",
                                     "build_dist_sell8d_plan",
                                     "build_dist_sell8d_cols_plan"])
def test_dist_sell_builders_refuse(builder):
    a = _bf(j_gen.clustered(3000, 3000, 8, spread=200, seed=6))
    with pytest.raises(ValueError, match="float32 or double-float") as e:
        getattr(jpar, builder)(a, jpar.make_mesh_1d(4))
    with pytest.raises(ValueError, match=str(e.value)[:45]):
        getattr(tpar, builder)(_port(a), tpar.make_mesh_1d(4, device="cpu"))


@pytest.mark.parametrize("gen", ["band", "clustered", "powerlaw"])
def test_dist_auto(gen):
    a = _bf(GENERATORS[gen]())
    jplan = jpar.build_dist_auto(a, jpar.make_mesh_1d(4))
    tplan = tpar.build_dist_auto(_port(a), tpar.make_mesh_1d(4,
                                                             device="cpu"))
    assert (tplan.kind, tplan.x_mode) == (jplan.kind, jplan.x_mode)
    assert tplan.kind == "scan"              # f32 would take a kernel kind
    assert (tplan.rest is None) == (jplan.rest is None)
    x = np.random.default_rng(7).standard_normal(a.n).astype(np.float32)
    _dist_check(jplan, tplan, a, x)


# -- the tools -------------------------------------------------------------------

def test_tune_rounds_x_to_bf16(tmp_path, monkeypatch):
    from spmv_tpu_torch.bench import timing
    monkeypatch.setenv("SPMV_TPU_TORCH_CACHE", str(tmp_path))
    seen = []
    chain = timing.time_spmv_chain

    def spy(fn, x, **kw):
        seen.append(x)
        return chain(fn, x, **kw)

    monkeypatch.setattr(timing, "time_spmv_chain", spy)
    a = _bf(j_gen.banded(2000, 2000, 3, seed=8))
    h, results = st.tune(_port(a), iters=1, repeats=1,
                                   mtx_token="bf16band", device="cpu")
    want = (np.random.default_rng(0).standard_normal(a.n).astype(BF16)
            .astype(np.float32))
    assert seen and all(x.dtype == torch.float32 for x in seen)
    np.testing.assert_array_equal(seen[0].numpy(), want)
    assert h.dtype == torch.bfloat16 and h.method_name in results
    rec = (tmp_path / "tune_bf16band.json").read_text()
    assert '"dtype": "bfloat16"' in rec


def test_suite_rows(capsys):
    from spmv_tpu_torch.bench import suite
    name, a = suite.load_any("builtin:uniform10k", dtype=torch.bfloat16)
    from spmv_tpu.bench import suite as j_suite
    jn, j = j_suite.load_any("builtin:uniform10k",
                             dtype=np.dtype(BF16))
    np.testing.assert_array_equal(a.vals, j.vals.view(np.uint16))
    rows = suite.bench_matrix(name, a, [st.Method.AUTO, st.Method.SERIAL],
                              iters=1, repeats=1, external=True,
                              device="cpu")
    assert [r.split(",")[1] for r in rows] == [
        "Method_Csr5Spmv", "Method_Serial", "ScipyCsr", "TorchCsr"]
    for r in rows:
        assert len(r.split(",")) == 10 and float(r.split(",")[5]) < 1e-4


@pytest.mark.parametrize("use_cache", [False, True])
def test_load_matrix_bf16(tmp_path, use_cache):
    # values off the bf16 grid, duplicates, a symmetric file
    path = tmp_path / "m.mtx"
    rng = np.random.default_rng(2)
    lines = [f"{r} {c} {float(v)!r}" for r, c, v in zip(
        rng.integers(1, 31, 80), rng.integers(1, 31, 80),
        rng.standard_normal(80) * 3)]
    path.write_text("%%MatrixMarket matrix coordinate real symmetric\n"
                    f"30 30 {len(lines)}\n" + "\n".join(lines) + "\n")
    kw = dict(use_cache=use_cache, cache_dir=str(tmp_path / "cache"))
    for _ in range(2):                     # with the cache: miss, then hit
        t = mmio.load_matrix(str(path), dtype=torch.bfloat16, **kw)
        j = j_mmio.load_matrix(str(path), dtype=BF16, **kw)
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.rowptr, j.rowptr)
        np.testing.assert_array_equal(t.vals, j.vals.view(np.uint16))
    r = mmio.read_mtx(str(path), dtype=torch.bfloat16)
    np.testing.assert_array_equal(
        r.vals, j_mmio.read_mtx(str(path), dtype=BF16).vals.view(np.uint16))


def test_solvers_on_bf16_handles():
    # an SPD band of dyadic values: its bf16 DIA handle and its f32 one
    # stream the same bf16 diagonals, so the solves agree bit for bit
    m = 3000
    rows = np.concatenate([np.arange(m), np.arange(1, m), np.arange(m - 1)])
    cols = np.concatenate([np.arange(m), np.arange(m - 1), np.arange(1, m)])
    vals = np.concatenate([np.full(m, 4.0), np.full(2 * (m - 1), -1.0)])
    a32 = st.CsrMatrix.from_coo(m, m, rows, cols, vals.astype(np.float32))
    h32 = st.create_handle(a32, device="cpu")
    h16 = st.create_handle(a32.astype(torch.bfloat16), device="cpu")
    b = np.random.default_rng(9).standard_normal(m).astype(np.float32)
    x16, r16, it16 = st.solvers.cg(h16, b, tol=1e-6, maxiter=200)
    x32, r32, it32 = st.solvers.cg(h32, b, tol=1e-6, maxiter=200)
    assert x16.dtype == torch.float32 and it16 == it32 and r16 == r32
    assert torch.equal(x16, x32)
    lam16, _ = st.solvers.power_iteration(h16, iters=30)
    lam32, _ = st.solvers.power_iteration(h32, iters=30)
    assert lam16 == lam32


def test_float16_still_refused():
    a = _port(j_gen.banded(50, 50, 2)).astype(np.float16)
    with pytest.raises(NotImplementedError, match="float16"):
        st.create_handle(a, device="cpu")
