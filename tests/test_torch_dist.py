"""The port's mesh plans (spmv_tpu_torch/parallel/mesh.py) against the JAX
package's (spmv_tpu/parallel/mesh.py) on the CPU.

The JAX side runs on its 8 virtual CPU devices (tests/conftest.py) with
its Pallas parts in interpret mode; the port runs on a mesh of one
repeated CPU device (``make_mesh_1d(n, device="cpu")``), where each shard
takes its kernels' plain versions.  Inputs come from numpy seeds.

- packs: the port's stacked (ndev, ...) arrays equal the JAX builders' bit
  for bit (dtype and values), for ndev 1, 4 and 8 and each x mode;
- executors: the port's output against the JAX plan's, and
  ``convert.dist_plan_from_reference`` (the port's executor on the JAX
  plan's own arrays) against the port's own plan.

Tolerances per row, scaled by max |y| as the JAX package's dist tests
scale them: f32 3e-6 (sums in another order); f64 1e-12 against the port's
own f64 golden sums, and 2e-6 against the JAX plan (its double-float
arithmetic runs at about f32 accuracy in interpret mode).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from spmv_tpu import parallel as jpar
from spmv_tpu.io import generate
from spmv_tpu.oracle import spmv_golden
from spmv_tpu.types import CsrMatrix as JaxCsr
from spmv_tpu_torch import convert, parallel as tpar
from spmv_tpu_torch.parallel import mesh as tmesh
from spmv_tpu_torch.types import CsrMatrix as TorchCsr


def _t(a):
    """The same matrix as the port's CsrMatrix."""
    return TorchCsr(a.m, a.n, a.rowptr, a.colidx, a.vals)


def _f64(a, seed=5):
    rng = np.random.default_rng(seed)
    return JaxCsr(a.m, a.n, a.rowptr, a.colidx, rng.standard_normal(a.nnz))


def _bf16_values(a, seed=7):
    """f32 values exact in bf16, too many for a palette."""
    rng = np.random.default_rng(seed)
    v = (rng.integers(1, 256, a.nnz) / 32.0).astype(np.float32)
    return JaxCsr(a.m, a.n, a.rowptr, a.colidx, v)


def _df_values(a):
    """f64 values one of which lies below df16's range (2^-100): the full
    hi + lo f32 planes."""
    b = _f64(a)
    b.vals[0] = 1e-35
    return b


def _square(m=8192, spread=200, dtype=np.float32, seed=6):
    """Clustered square matrix: columns within one 1024-row block of their
    row, so every mesh width here admits a depth-1 halo ring."""
    return generate.clustered(m, m, 8, spread=spread, dtype=dtype,
                              seed=seed, exact=False)


#: kind → (JAX builder, port pack function, the matrix, builder kwargs, x
#: modes); the pack functions return (static fields, stacked arrays)
KINDS = {
    "scan": (jpar.build_dist_plan, "scan",
             lambda: _square(dtype=np.float64), dict(tile=256),
             ("replicated", "allgather", "halo")),
    "dia": (jpar.build_dist_dia_plan, "dia",
            lambda: generate.banded(3000, 3000, 4, seed=1), {},
            ("replicated", "allgather", "halo")),
    "sell8w": (jpar.build_dist_sell8w_plan, "sell8w", _square, {},
               ("replicated", "allgather", "halo")),
    "sell8w_f64": (jpar.build_dist_sell8w_plan, "sell8w",
                   lambda: _f64(_square()), {},
                   ("replicated", "allgather", "halo")),
    "sell8d": (jpar.build_dist_sell8d_plan, "sell8d", _square,
               dict(nw=1), ("replicated", "allgather", "halo")),
    "sell8d_df16": (jpar.build_dist_sell8d_plan, "sell8d",
                    lambda: _f64(_square()), dict(nw=1),
                    ("replicated", "allgather", "halo")),
    "sell8d_palette_df": (jpar.build_dist_sell8d_plan, "sell8d",
                          lambda: generate.random_uniform(
                              6000, 6000, 8, dtype=np.float64, seed=9),
                          dict(max_pad_ratio=200.0), ("replicated",)),
    "sell8d_palette_nw2": (jpar.build_dist_sell8d_plan, "sell8d",
                           lambda: generate.random_uniform(
                               5000, 7000, 8, dtype=np.float32, seed=3),
                           dict(nw=2, max_pad_ratio=200.0),
                           ("replicated", "allgather")),
    "sell8d_bf16": (jpar.build_dist_sell8d_plan, "sell8d",
                    lambda: _bf16_values(_square()), dict(nw=1),
                    ("halo",)),
    "sell8d_df": (jpar.build_dist_sell8d_plan, "sell8d",
                  lambda: _df_values(_square()), dict(nw=1),
                  ("allgather",)),
    "cols": (jpar.build_dist_sell8d_cols_plan, "cols",
             lambda: generate.random_uniform(1500, 8 * 8192 + 5000, 12,
                                             dtype=np.float32, seed=1),
             dict(max_pad_ratio=256.0), (None,)),
}


def _port_pack(kind, a, ndev, x_mode, kw):
    kind, a = KINDS[kind][1], _t(a)
    if kind == "scan":
        if x_mode == "halo":
            return tmesh._pack_scan_halo(a, ndev, kw["tile"], 1)
        return tmesh._pack_scan(a, ndev, kw["tile"], x_mode)
    if kind == "dia":
        return tmesh._pack_dia(a, ndev, x_mode)
    if kind == "sell8w":
        return tmesh._pack_sell8w(a, ndev, x_mode, None)
    if kind == "sell8d":
        return tmesh._pack_sell8d(a, ndev, x_mode, kw.get("nw"),
                                  kw.get("max_pad_ratio", 32.0))
    return tmesh._pack_sell8d_cols(a, ndev, None,
                                   kw.get("max_pad_ratio", 32.0))


def _jax_build(kind, a, ndev, x_mode, kw):
    build = KINDS[kind][0]
    mode = {} if x_mode is None else {"x_mode": x_mode}
    interp = {} if build in (jpar.build_dist_plan,
                             jpar.build_dist_dia_plan) else {
        "interpret": True}
    return build(a, jpar.make_mesh_1d(ndev), **mode, **kw, **interp)


def _host(v):
    v = np.asarray(v)
    return v.view(np.uint16) if v.dtype.name == "bfloat16" else v


def _assert_same_pack(jplan, static, arrays):
    """The port's pack against the JAX plan: every static field and every
    stacked array, bit for bit (the JAX plan's replicated (8, 128) dummies
    of the palette modes have no counterpart)."""
    static_names, array_names, _place = convert._DIST[type(jplan).__name__]
    for k in static_names:
        want, got = getattr(jplan, k, 0), static[k.lstrip("_")]
        if k == "rest":
            assert (want is None) == (got is None)
            if want is not None:
                for w, g in zip(want, got):
                    np.testing.assert_array_equal(np.asarray(w), g)
        elif isinstance(want, (np.ndarray, tuple)):
            np.testing.assert_array_equal(np.asarray(want), np.asarray(got))
        else:
            assert want == got, (k, want, got)
    for k in array_names:
        want, got = getattr(jplan, k, None), arrays.get(k.lstrip("_"))
        if got is None:
            assert want is None or np.asarray(want).shape == (8, 128), k
            continue
        want = _host(want)
        assert want.dtype == got.dtype, (k, want.dtype, got.dtype)
        np.testing.assert_array_equal(want, got, err_msg=k)


@pytest.mark.parametrize("ndev", [1, 4, 8])
@pytest.mark.parametrize("kind", list(KINDS))
def test_dist_packs_bit_identical(kind, ndev, x64):
    _build, _pk, make, kw, modes = KINDS[kind]
    a = make()
    for x_mode in modes:
        try:
            jplan = _jax_build(kind, a, ndev, x_mode, kw)
        except ValueError as e:
            # the same refusal (a halo ring that would cover the mesh)
            with pytest.raises(ValueError, match=str(e).split()[0]):
                _port_pack(kind, a, ndev, x_mode, kw)
            continue
        static, arrays = _port_pack(kind, a, ndev, x_mode, kw)
        _assert_same_pack(jplan, static, arrays)


@pytest.fixture
def x64():
    import jax
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", was)


def _exec_case(kind, ndev, x_mode, a=None):
    """(JAX plan, port plan, x, golden y) for one kind and x mode."""
    _build, _pk, make, kw, _modes = KINDS[kind]
    a = make() if a is None else a
    jplan = _jax_build(kind, a, ndev, x_mode, kw)
    mode = {} if x_mode is None else {"x_mode": x_mode}
    tbuild = getattr(tpar, KINDS[kind][0].__name__)
    tplan = tbuild(_t(a), tpar.make_mesh_1d(ndev, device="cpu"), **mode,
                   **kw)
    rng = np.random.default_rng(ndev)
    x = rng.standard_normal(a.n).astype(a.vals.dtype)
    return jplan, tplan, x, spmv_golden(a.astype(np.float64),
                                        x.astype(np.float64))


def _check_against_jax(jplan, tplan, x, ref):
    y = tplan(torch.from_numpy(x))
    want = np.asarray(jplan(x), dtype=np.float64)
    df = y.dtype == torch.float64
    assert y.dtype == (torch.float64 if x.dtype == np.float64
                       else torch.float32)
    y = y.numpy().astype(np.float64)
    scale = max(np.abs(ref).max(), 1.0)
    if df:
        np.testing.assert_allclose(y / scale, ref / scale, atol=1e-12)
    np.testing.assert_allclose(y / scale, want / scale,
                               atol=2e-6 if df else 3e-6)
    # the port's executor on the JAX plan's own arrays: the same y
    mesh = tpar.make_mesh_1d(tplan.ndev, device="cpu")
    y_ref = convert.dist_plan_from_reference(jplan, mesh)(
        torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(y_ref, y.astype(y_ref.dtype))


@pytest.mark.parametrize("kind,x_mode", [
    (k, m) for k in KINDS for m in KINDS[k][4]])
def test_dist_executor_matches_jax(kind, x_mode, x64):
    _check_against_jax(*_exec_case(kind, 4, x_mode))


# -- the edge cases of tests/test_parallel.py --------------------------------

def test_sell8w_uneven_rows_and_empty_shards(x64):
    # m not divisible by ndev*128: the last shards are padding only
    a = generate.clustered(777, 900, 10, spread=150, dtype=np.float32,
                           seed=7)
    jplan, tplan, x, ref = _exec_case("sell8w", 8, "replicated", a)
    assert tplan.mr * 7 > a.m          # the last shard holds no row
    _check_against_jax(jplan, tplan, x, ref)


def test_sell8w_allgather_indivisible_n(x64):
    a = generate.clustered(900, 900, 12, spread=120, dtype=np.float32,
                           seed=9)
    _check_against_jax(*_exec_case("sell8w", 8, "allgather", a))


def test_sell8d_empty_shards(x64):
    # m < ndev * 1024: several shards hold no row and keep the default
    # stream, whose outputs must come back zero
    a = generate.random_uniform(1700, 2600, 5, dtype=np.float32, seed=4)
    _check_against_jax(*_exec_case("sell8d", 8, "replicated", a))


def test_scan_halo_cyclic_wrap(x64):
    # a cyclic band: row 0 reads the last columns and the last rows the
    # first; the ring is circular, so depth 1 (not ndev - 1) suffices
    m = 1024
    base = generate.banded(m, m, 2, seed=4)
    rows = np.concatenate([np.repeat(np.arange(m), base.row_lengths),
                           np.arange(3), m - 1 - np.arange(3)])
    cols = np.concatenate([base.colidx.astype(np.int64),
                           m - 1 - np.arange(3), np.arange(3)])
    vals = np.concatenate([base.vals, np.full(6, 0.5)])
    a = JaxCsr.from_coo(m, m, rows, cols, vals)
    jplan = jpar.build_dist_plan(a, jpar.make_mesh_1d(8), tile=128,
                                 x_mode="halo")
    tplan = tpar.build_dist_plan(_t(a), tpar.make_mesh_1d(8, device="cpu"),
                                 tile=128, x_mode="halo")
    assert tplan.halo == jplan._halo <= 2
    x = np.random.default_rng(2).standard_normal(m)
    _check_against_jax(jplan, tplan, x, spmv_golden(a, x))


def test_halo_rejects_scatter_and_rectangles():
    mesh = tpar.make_mesh_1d(8, device="cpu")
    a = generate.random_uniform(512, 512, 6, seed=3)
    with pytest.raises(ValueError, match="halo depth"):
        tpar.build_dist_plan(_t(a), mesh, x_mode="halo")
    with pytest.raises(ValueError, match="halo depth"):
        tpar.build_dist_sell8d_plan(
            _t(generate.random_uniform(9000, 9000, 8, dtype=np.float32,
                                       seed=3)),
            tpar.make_mesh_1d(4, device="cpu"), x_mode="halo", nw=1)
    with pytest.raises(ValueError):
        tpar.build_dist_dia_plan(_t(generate.banded(200, 350, 3)), mesh,
                                 x_mode="halo")
    with pytest.raises(ValueError):          # band wider than a shard
        tpar.build_dist_dia_plan(_t(generate.banded(64, 64, 20)), mesh,
                                 x_mode="halo")


def test_unsupported_dtype_rejected():
    a = generate.clustered(500, 500, 10, spread=100, dtype=np.float16)
    mesh = tpar.make_mesh_1d(4, device="cpu")
    with pytest.raises(ValueError, match="float32 or double-float"):
        tpar.build_dist_sell8w_plan(_t(a), mesh)
    with pytest.raises(ValueError, match="float32 or double-float"):
        tpar.build_dist_sell8d_plan(_t(a), mesh)


@pytest.mark.parametrize("seed", range(4))
def test_scan_fuzz_against_golden(seed):
    # random structures × random mesh widths, as test_dist_fuzz
    rng = np.random.default_rng(2000 + seed)
    m, n = (int(v) for v in rng.integers(2, 600, 2))
    nnz = int(rng.integers(0, min(m * n, 4000)))
    a = JaxCsr.from_coo(m, n, rng.integers(0, m, nnz),
                        rng.integers(0, n, nnz), rng.standard_normal(nnz))
    ndev = int(rng.choice([1, 2, 3, 5, 8]))
    x_mode = str(rng.choice(["replicated", "allgather"]))
    plan = tpar.build_dist_plan(_t(a), tpar.make_mesh_1d(ndev, device="cpu"),
                                tile=128, x_mode=x_mode)
    x = rng.standard_normal(n)
    np.testing.assert_allclose(plan(x).numpy(), spmv_golden(a, x),
                               rtol=1e-9, atol=1e-11)


# -- the mesh and the package boundary ---------------------------------------

def test_make_mesh_1d():
    mesh = tpar.make_mesh_1d(8, device="cpu")
    assert mesh.shape == {"rows": 8}
    assert mesh.devices == (torch.device("cpu"),) * 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA devices"):
            tpar.make_mesh_1d(2)


def test_parallel_exports_the_reference_names():
    assert tpar.__all__ == jpar.__all__
    for name in tpar.__all__:
        assert callable(getattr(tpar, name))


def test_parallel_imports_no_jax():
    code = ("import sys, spmv_tpu_torch.parallel, spmv_tpu_torch.convert, "
            "spmv_tpu_torch.parallel.multihost; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'spmv_tpu.')) "
            "or m == 'spmv_tpu'); print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
