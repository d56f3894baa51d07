"""Iterative solvers on the handle API (the port of ``spmv_tpu/solvers.py``)
— the execute-many workload.

The reference's vestigial ITSOL heritage (src/samples/data-types.h:30-302
declares FGMRES/BiCGSTAB enums that nothing uses) points at the intended
workload: Krylov solvers calling SpMV hundreds of times per matrix.

The JAX package runs each solve as one ``lax.while_loop`` on the device.
Eager PyTorch has no device-side loop, and reading the stopping test on the
host each iteration would make the host wait for the card each iteration.
So the loop enqueues a block of iterations, then reads the test once; the
blocks grow 1, 2, 4, ... up to ``CHECK_EVERY`` iterations, so a solve that
converges in a few iterations enqueues few past it.  Each iteration
computes the JAX loop's condition on the device first; once it is false
the iteration's step sizes become 0 through ``torch.where`` and its
counter stops, so x, the residual and the iteration count are exactly what
the JAX loop returns, not what the iterations enqueued past convergence
would leave.  ``host_syncs`` counts the host's reads.

Each call of a solver lies in a ``solver.solve`` span, and each host read
in a ``solver.read`` span (``utils/profiling.py``): one read, one span.

All solvers accept an :class:`~spmv_tpu_torch.handle.SpmvHandle`, a mesh
plan of ``spmv_tpu_torch.parallel``, or any ``x -> y`` callable, and
return tensors on the device of b (or of the operator, for a numpy b).
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import numpy as np
import torch

from .utils.profiling import span, spanned

__all__ = ["cg", "bicgstab", "power_iteration", "CHECK_EVERY"]

#: the most iterations enqueued between two host reads of the stopping
#: test (the blocks double up to it)
CHECK_EVERY = 8

#: the host's reads of a solver's state (one a block of iterations, and
#: one for the result); a module global, not a ``utils.profiling``
#: counter, because callers (the benchmark among them) read it by this name
host_syncs = 0


def _as_fn(a) -> Callable:
    bound = getattr(a, "_bound", None)
    if bound is not None:
        return bound
    return a


def _device_of(a) -> torch.device:
    """A handle's device, a mesh plan's home device (where it takes x),
    else the card."""
    dev = getattr(a, "device", None)
    if dev is None and getattr(a, "mesh", None) is not None:
        dev = a.mesh.home
    return torch.device(dev if dev is not None else "cuda")


def _vector(a, b) -> torch.Tensor:
    """b as a tensor: a tensor stays where it is, a numpy array goes to the
    operator's device; a handle's type is the solve's type (f32 for a bf16
    matrix)."""
    b = torch.as_tensor(b, device=None if isinstance(b, torch.Tensor)
                        else _device_of(a))
    if getattr(a, "_bound", None) is not None:
        b = b.to(torch.float64 if a.dtype == np.float64
                 else torch.float32)
    return b.contiguous()


def _read(t: torch.Tensor):
    """One host read of the device state."""
    global host_syncs
    host_syncs += 1
    with span("solver.read"):
        return t.tolist()


def _run(body: Callable, cond: Callable, maxiter: int) -> None:
    """At most ``maxiter`` calls of ``body``, in blocks of 1, 2, 4, ...,
    CHECK_EVERY with a host read of ``cond()`` after each; ``body`` freezes
    its state when its own test fails, so the iterations past it change
    nothing."""
    done, block = 0, 1
    while done < maxiter:
        block = min(block, maxiter - done)
        for _ in range(block):
            body()
        done += block
        if not _read(cond()):
            break
        block = min(2 * block, CHECK_EVERY)


@functools.partial(spanned, "solver.solve")
def cg(a, b, tol: float = 1e-6, maxiter: int = 1000,
       x0=None) -> Tuple[torch.Tensor, float, int]:
    """Conjugate gradients for SPD A.  Returns (x, residual_norm, iters)."""
    spmv = _as_fn(a)
    b = _vector(a, b)
    x = torch.zeros_like(b) if x0 is None else _vector(a, x0).to(b.dtype)
    r = b - spmv(x)
    tol2 = tol * tol
    zero = b.new_zeros(())
    st = {"x": x, "r": r, "p": r, "rs": torch.dot(r, r),
          "it": torch.zeros((), dtype=torch.int64, device=b.device)}

    def body():
        x, r, p, rs = st["x"], st["r"], st["p"], st["rs"]
        live = rs > tol2
        ap = spmv(p)
        alpha = torch.where(live, rs / torch.dot(p, ap), zero)
        x = torch.addcmul(x, p, alpha)
        r = torch.addcmul(r, ap, alpha, value=-1)
        rs_new = torch.dot(r, r)
        # frozen: p = r, so every later product stays finite
        p = torch.addcmul(r, p, torch.where(live, rs_new / rs, zero))
        st.update(x=x, r=r, p=p, rs=torch.where(live, rs_new, rs),
                  it=st["it"] + live)

    _run(body, lambda: st["rs"] > tol2, maxiter)
    rs, iters = _read(torch.stack([st["rs"].sqrt(),
                                   st["it"].to(st["rs"].dtype)]))
    return st["x"], float(rs), int(iters)


@functools.partial(spanned, "solver.solve")
def bicgstab(a, b, tol: float = 1e-6, maxiter: int = 1000,
             x0=None) -> Tuple[torch.Tensor, float, int]:
    """BiCGSTAB for general (nonsymmetric) A.

    The algorithm the reference's data-types.h enum names (`BICGSTAB`),
    actually implemented.  Returns (x, residual_norm, iters).
    """
    spmv = _as_fn(a)
    b = _vector(a, b)
    x = torch.zeros_like(b) if x0 is None else _vector(a, x0).to(b.dtype)
    r = b - spmv(x)
    rhat = r
    tol2 = tol * tol
    zero = b.new_zeros(())
    eps = b.new_full((), 1e-30)
    one = b.new_ones(())
    st = {"x": x, "r": r, "p": torch.zeros_like(r), "v": torch.zeros_like(r),
          "rho": one, "alpha": one, "omega": one,
          "it": torch.zeros((), dtype=torch.int64, device=b.device)}

    def body():
        x, r, p, v = st["x"], st["r"], st["p"], st["v"]
        rho, alpha, omega = st["rho"], st["alpha"], st["omega"]
        live = torch.dot(r, r) > tol2
        rho_new = torch.dot(rhat, r)
        beta = (rho_new / torch.where(rho == 0, eps, rho)) \
            * (alpha / torch.where(omega == 0, eps, omega))
        p = torch.addcmul(r, torch.addcmul(p, v, omega, value=-1), beta)
        v = spmv(p)
        # frozen: alpha = omega = 0, so s = r, x and r stay, and the next
        # beta is 0 (p = r): every later product stays finite
        alpha = torch.where(live, rho_new / torch.dot(rhat, v), zero)
        s = torch.addcmul(r, v, alpha, value=-1)
        t = spmv(s)
        tt = torch.dot(t, t)
        omega = torch.where(live & (tt != 0), torch.dot(t, s) / tt, zero)
        x = torch.addcmul(torch.addcmul(x, p, alpha), s, omega)
        r = torch.addcmul(s, t, omega, value=-1)
        st.update(x=x, r=r, p=p, v=v, rho=rho_new, alpha=alpha,
                  omega=omega, it=st["it"] + live)

    _run(body, lambda: torch.dot(st["r"], st["r"]) > tol2, maxiter)
    rr, iters = _read(torch.stack([torch.dot(st["r"], st["r"]).sqrt(),
                                   st["it"].to(b.dtype)]))
    return st["x"], float(rr), int(iters)


@functools.partial(spanned, "solver.solve")
def power_iteration(a, n: int = None, iters: int = 100,
                    seed: int = 0) -> Tuple[float, torch.Tensor]:
    """Dominant eigenvalue/vector via repeated SpMV (square A).  No host
    read until λ: the loop has a fixed count."""
    spmv = _as_fn(a)
    if n is None:
        n = a.n                       # works for handles and mesh plans
    dtype = np.float64 if getattr(a, "dtype", np.float32) == np.float64 \
        else np.float32
    v = torch.from_numpy(np.random.default_rng(seed).standard_normal(n)
                         .astype(dtype)).to(_device_of(a))
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        w = spmv(v)
        v = w / torch.linalg.vector_norm(w)
    lam = _read(torch.dot(v, spmv(v)))
    return float(lam), v
