"""The port's distributed AUTO router (spmv_tpu_torch.parallel
build_dist_auto) against the JAX package's on every matrix of
tests/test_dist_auto.py: the same plan kind, x mode, value mode, pad and
straggler stream, a y within the JAX tests' bounds of spmv_golden, and the
port's executor on the JAX plan's own arrays (convert.dist_plan_from_reference)
giving the port's own y.

The JAX plans are built, not run (their output is held to the port's in
tests/test_torch_dist.py); the port runs on a mesh of one repeated CPU
device.  Bound against spmv_golden, per row: 1e-5·(|A||x|)_i + 1e-6 (f32
sums in another order; a web graph's heavy rows cancel); the scan's f32
cumsum carries about eps·sqrt(nnz) absolute error, so it keeps the JAX
test's atol 2e-4 at 150k nonzeros.
"""

import numpy as np
import pytest
import torch

from spmv_tpu import parallel as jpar
from spmv_tpu.io import generate
from spmv_tpu.oracle import spmv_golden
from spmv_tpu.types import CsrMatrix as JaxCsr
from spmv_tpu_torch import convert, parallel as tpar
from spmv_tpu_torch.types import CsrMatrix as TorchCsr


def _ultra_sparse():
    rng = np.random.default_rng(7)
    m = 1_000_000
    rows = np.sort(rng.integers(0, m, 150_000))
    cols = rng.integers(0, m, 150_000)
    return JaxCsr.from_coo(m, m, rows, cols,
                           rng.standard_normal(150_000).astype(np.float32))


def _f64_uniform():
    a32 = generate.random_uniform(5000, 5000, 8, dtype=np.float32, seed=5)
    rng = np.random.default_rng(6)
    return JaxCsr(a32.m, a32.n, a32.rowptr, a32.colidx,
                  rng.standard_normal(a32.nnz))


def _banded_with_stragglers():
    a = generate.banded(6000, 6000, 3, dtype=np.float32, seed=9)
    rng = np.random.default_rng(10)
    k = a.nnz // 1000                      # ~0.1% long-range entries
    rows = rng.integers(0, 3000, k)
    cols = np.minimum(rows + 3000 + rng.integers(0, 2500, k), a.n - 1)
    r_all = np.concatenate([np.repeat(np.arange(a.m), a.row_lengths), rows])
    c_all = np.concatenate([np.asarray(a.colidx, dtype=np.int64), cols])
    v_all = np.concatenate([np.asarray(a.vals),
                            rng.standard_normal(k).astype(np.float32)])
    return JaxCsr.from_coo(a.m, a.n, r_all, c_all, v_all)


#: name → (matrix, ndev, x_mode asked for, the kind tests/test_dist_auto.py
#: expects, atol against spmv_golden)
MATRICES = {
    "banded": (lambda: generate.banded(6000, 6000, 3, dtype=np.float32,
                                       seed=1), 8, "auto", "dia", 1e-6),
    "clustered": (lambda: generate.clustered(
        4000, 4000, 10, spread=300, dtype=np.float32, seed=2, exact=False),
        4, "auto", None, 1e-6),
    "uniform": (lambda: generate.random_uniform(6000, 6000, 8,
                                                dtype=np.float32, seed=3),
                4, "auto", "sell8d", 1e-6),
    "powerlaw": (lambda: generate.power_law(20_000, 20_000, 16 * 20_000,
                                            dtype=np.float32, seed=4),
                 4, "auto", None, 1e-6),
    "f64_uniform": (_f64_uniform, 4, "auto", None, 1e-6),
    "ultra_sparse": (_ultra_sparse, 4, "auto", "scan", 2e-4),
    "large_n": (lambda: generate.random_uniform(30_000, 2_500_000, 64,
                                                dtype=np.float32, seed=20),
                8, "auto", "sell8d_cols", 1e-6),
    "webbase": (lambda: generate.webbase_like(60_000, 60_000, 190_000,
                                              dtype=np.float32, seed=21),
                4, "auto", None, 1e-6),
    # a larger webbase-shaped graph takes the graph split: hub columns,
    # heavy rows on SELL-8W (K9), light rows on SELL-8D
    "webbase100k": (lambda: generate.webbase_like(
        100_000, 100_000, 310_000, dtype=np.float32, seed=11), 4, "auto",
        "graph", 1e-6),
    "halo_stragglers": (_banded_with_stragglers, 8, "auto", None, 1e-6),
    "forced_replicated": (lambda: generate.random_uniform(
        4000, 4000, 8, dtype=np.float32, seed=8), 4, "replicated", None,
        1e-6),
    "forced_allgather": (lambda: generate.random_uniform(
        4000, 4000, 8, dtype=np.float32, seed=8), 4, "allgather", None,
        1e-6),
}


def _leaves(plan):
    """The mesh plans of an auto plan's parts, by part name."""
    return {k: v for k, v in plan.parts.items() if hasattr(v, "x_mode")}


@pytest.mark.parametrize("name", list(MATRICES))
def test_dist_auto_routes_as_the_reference(name):
    make, ndev, x_mode, expect, atol = MATRICES[name]
    a = make()
    jplan = jpar.build_dist_auto(a, jpar.make_mesh_1d(ndev), x_mode=x_mode,
                                 interpret=True)
    mesh = tpar.make_mesh_1d(ndev, device="cpu")
    ta = TorchCsr(a.m, a.n, a.rowptr, a.colidx, a.vals)
    tplan = tpar.build_dist_auto(ta, mesh, x_mode=x_mode)
    assert (tplan.kind, tplan.x_mode, tplan.value_mode) == (
        jplan.kind, jplan.x_mode, jplan.value_mode)
    assert tplan.max_pad == jplan.max_pad
    if expect is not None:
        assert tplan.kind == expect
    if x_mode != "auto":
        assert tplan.x_mode == x_mode
    assert (tplan.rest is None) == (jplan.rest is None)
    if jplan.rest is not None:
        for got, want in zip(tplan.rest, jplan.rest):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert sorted(tplan.parts) == sorted(jplan.parts)
    for k, part in _leaves(jplan).items():
        assert type(tplan.parts[k]).__name__ == type(part).__name__
        assert tplan.parts[k].x_mode == part.x_mode
    if name == "webbase100k":
        assert {"heavy", "light", "hub_cols"} <= set(tplan.parts)
    if name == "halo_stragglers":
        # the ~0.1% long-range entries ride the rest stream, halo holds
        assert tplan.x_mode.startswith("halo") and len(tplan.rest[0]) > 0
    x = generate.make_x(a.n, a.dtype, kind="normal", seed=11)
    y = tplan(torch.from_numpy(x))
    ref = spmv_golden(a.astype(np.float64), x.astype(np.float64))
    absref = spmv_golden(JaxCsr(a.m, a.n, a.rowptr, a.colidx,
                                np.abs(a.vals).astype(np.float64)),
                         np.abs(x).astype(np.float64))
    np.testing.assert_array_less(
        np.abs(y.numpy().astype(np.float64) - ref), 1e-5 * absref + atol)
    y_ref = convert.dist_plan_from_reference(jplan, mesh)(
        torch.from_numpy(x))
    np.testing.assert_array_equal(y_ref.numpy(), y.numpy())
