"""The port's solvers against the JAX package's (tests/test_solvers.py), on
device="cpu", the same matrix and b through both.

Held:
- f64 (JAX with x64 on): the same iteration count, x within 1e-10
  relative (max-norm), the residual within 1e-8 relative;
- f32: the iteration count within ±1, x within 1e-4 relative;
- power_iteration: λ within 1e-5 relative;
- the blocked stopping test: ``host_syncs`` reads a solve (blocks of 1,
  2, 4, ... CHECK_EVERY iterations), and a solve that converges inside a
  block (or stops at ``maxiter``) returns the JAX loop's x and count, not
  what the iterations enqueued after it leave;
- handles, plain callables and a port mesh plan (``make_mesh_1d(4,
  device="cpu")``) as the operator.
"""

import numpy as np
import pytest
import torch

import spmv_tpu as js
from spmv_tpu import solvers as jsol
from spmv_tpu.io import generate as j_gen
import spmv_tpu_torch as st
from spmv_tpu_torch import parallel, solvers
from spmv_tpu_torch.io import generate


def _spd(m=800, seed=1):
    """tests/test_solvers.py's SPD matrix: (A + Aᵀ)/2 of diag_plus_random."""
    a = generate.diag_plus_random(m, nnz_per_row=6, seed=seed)
    rows = np.repeat(np.arange(a.m), a.row_lengths)
    return st.CsrMatrix.from_coo(
        a.m, a.n,
        np.concatenate([rows, a.colidx]),
        np.concatenate([a.colidx, rows]),
        np.concatenate([a.vals, a.vals]) * 0.5)


def _jax(a):
    return js.CsrMatrix(a.m, a.n, a.rowptr, a.colidx, a.vals)


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.abs(x - ref).max() / np.abs(ref).max()


def _reads(iters, maxiter=1000):
    """The host reads of a solve that stops after ``iters`` iterations:
    one after each block (1, 2, 4, ... up to CHECK_EVERY iterations) until
    the blocks cover ``iters`` (or reach ``maxiter``), and one for the
    result."""
    done, block, reads = 0, 1, 1
    while done < maxiter:
        done += min(block, maxiter - done)
        reads += 1
        if done >= max(iters, 1):
            break
        block = min(2 * block, solvers.CHECK_EVERY)
    return reads


def _pair(a, method=st.Method.AUTO):
    return (st.create_handle(a, method=method, device="cpu"),
            js.create_handle(_jax(a), method=js.Method(int(method))))


def _matrix(kind, dtype):
    if kind == "spd":
        return _spd().astype(dtype)
    return generate.diag_plus_random(600, nnz_per_row=5, seed=3) \
        .astype(dtype)


@pytest.mark.parametrize("solver,kind,method", [
    ("cg", "spd", st.Method.AUTO),
    ("cg", "spd", st.Method.SELL_C_SIGMA),
    ("bicgstab", "nonsym", st.Method.BALANCED),
    ("bicgstab", "nonsym", st.Method.AUTO),
])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_solver_matches_jax(solver, kind, method, dtype):
    a = _matrix(kind, dtype)
    ht, hj = _pair(a, method)
    b = np.random.default_rng(2).standard_normal(a.n).astype(dtype)
    tol = 1e-8 if dtype == np.float64 else 1e-4
    xj, rj, ij = getattr(jsol, solver)(hj, b, tol=tol)
    xt, rt, it = getattr(solvers, solver)(ht, b, tol=tol)
    assert isinstance(xt, torch.Tensor) and xt.device.type == "cpu"
    assert xt.dtype == (torch.float64 if dtype == np.float64
                        else torch.float32)
    assert 0 < it < 1000 and rt <= tol
    if dtype == np.float64:
        assert it == ij
        assert _rel(xt, xj) < 1e-10
        assert abs(rt - rj) <= 1e-8 * rj
    else:
        assert abs(it - ij) <= 1
        assert _rel(xt, xj) < 1e-4
    # the solution solves the system (tests/test_solvers.py's check)
    ax = st.spmv_golden(a.astype(np.float64), xt.numpy().astype(np.float64))
    assert np.abs(ax - b).max() < (1e-6 if dtype == np.float64 else 1e-3)


@pytest.mark.parametrize("maxiter,tol", [(5, 1e-8), (13, 0.0)])
def test_cg_stops_at_maxiter_as_jax(maxiter, tol):
    # tol = 0 is the HPCG run: exactly maxiter iterations; the last block
    # is cut at maxiter
    a = _spd(500, seed=4)
    ht, hj = _pair(a)
    b = np.random.default_rng(5).standard_normal(a.n)
    xj, rj, ij = jsol.cg(hj, b, tol=tol, maxiter=maxiter)
    solvers.host_syncs = 0
    xt, rt, it = solvers.cg(ht, b, tol=tol, maxiter=maxiter)
    assert it == ij == maxiter
    assert _rel(xt, xj) < 1e-10 and abs(rt - rj) <= 1e-8 * rj
    assert solvers.host_syncs == _reads(maxiter, maxiter)


def test_frozen_iterations_leave_the_state():
    # converging in the middle of a block: the iterations enqueued after
    # it must not move x, and the count stops where the JAX loop stops
    a = _spd(300, seed=6)
    ht, hj = _pair(a)
    b = np.random.default_rng(7).standard_normal(a.n)
    for tol in (1e-3, 1e-6, 1e-9, 1e-12):
        xj, _, ij = jsol.cg(hj, b, tol=tol)
        solvers.host_syncs = 0
        xt, _, it = solvers.cg(ht, b, tol=tol)
        assert it == ij and _rel(xt, xj) < 1e-10
        assert solvers.host_syncs == _reads(it)
        xj, _, ij = jsol.bicgstab(hj, b, tol=tol)
        xt, _, it = solvers.bicgstab(ht, b, tol=tol)
        assert it == ij and _rel(xt, xj) < 1e-10


def test_zero_rhs_returns_at_once():
    # r = 0 from the start: no iteration, x = 0, as the JAX loop
    a = _spd(200, seed=8)
    ht, _ = _pair(a)
    for solver in (solvers.cg, solvers.bicgstab):
        x, res, it = solver(ht, np.zeros(a.n))
        assert it == 0 and res == 0.0 and not x.any()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_power_iteration_matches_jax(dtype):
    a = _spd(400, seed=5).astype(dtype)
    ht, hj = _pair(a)
    lj, vj = jsol.power_iteration(hj, iters=200)
    solvers.host_syncs = 0
    lt, vt = solvers.power_iteration(ht, iters=200)
    assert solvers.host_syncs == 1
    assert abs(lt - lj) <= 1e-5 * abs(lj)
    assert vt.dtype == (torch.float64 if dtype == np.float64
                        else torch.float32)
    av = st.spmv(ht, vt).numpy()
    assert np.abs(av - lt * vt.numpy()).max() < 1e-3 * abs(lt)


def test_solvers_accept_plain_callables():
    """Any x -> y works (tests/test_solvers.py's callable case)."""
    a = _spd(300, seed=6)
    ht, hj = _pair(a)
    b = np.random.default_rng(7).standard_normal(a.n)
    xj, rj, ij = jsol.cg(lambda v: hj._bound(v), b, tol=1e-8)
    x, res, it = solvers.cg(lambda v: ht._bound(v), torch.from_numpy(b),
                            tol=1e-8)
    assert res < 1e-7 and it == ij and _rel(x, xj) < 1e-10


def test_solvers_accept_mesh_plans():
    # a port mesh plan (4 shards of the CPU) is an operator too; numpy b
    # goes to the mesh's first device
    a = _spd(600, seed=9)
    _, hj = _pair(a)
    mesh = parallel.make_mesh_1d(4, device="cpu")
    plan = parallel.build_dist_plan(a, mesh)
    b = np.random.default_rng(10).standard_normal(a.n)
    xj, rj, ij = jsol.cg(hj, b, tol=1e-8)
    x, res, it = solvers.cg(plan, b, tol=1e-8)
    assert x.device.type == "cpu" and it == ij and _rel(x, xj) < 1e-10
    xj, _, ij = jsol.bicgstab(hj, b, tol=1e-8)
    x, _, it = solvers.bicgstab(plan, b, tol=1e-8)
    assert it == ij and _rel(x, xj) < 1e-10
    lj, _ = jsol.power_iteration(hj, iters=100)
    lt, v = solvers.power_iteration(plan, iters=100)
    assert abs(lt - lj) <= 1e-5 * abs(lj) and v.shape == (a.n,)


def test_jax_solvers_see_the_same_matrix():
    # the port's generator and the JAX generator build one matrix
    a = _spd(300, seed=6)
    j = j_gen.diag_plus_random(300, nnz_per_row=6, seed=6)
    t = generate.diag_plus_random(300, nnz_per_row=6, seed=6)
    for k in ("rowptr", "colidx", "vals"):
        assert np.array_equal(getattr(j, k), getattr(t, k))
    assert a.nnz > t.nnz
