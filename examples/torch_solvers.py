"""Iterative solvers on the PyTorch port's handle API — the execute-many
story (the counterpart of ``examples/solvers.py``).

The handle packs once; every iteration is device work.  The solvers read
their stopping test on the host once every ``CHECK_EVERY`` iterations, and
``solvers.host_syncs`` counts those reads.

Run:  python examples/torch_solvers.py                 # on the card
      python examples/torch_solvers.py --device cpu --m 2000
"""

import argparse
import os
import sys
import time

# allow `python examples/<name>.py` without installing the package
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

import spmv_tpu_torch as st
from spmv_tpu_torch import solvers
from spmv_tpu_torch.io import generate


def _wait(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--m", type=int, default=200_000,
                   help="rows of the SPD system")
    p.add_argument("--dtype", default="float64",
                   choices=["float32", "float64"])
    args = p.parse_args(argv)
    dtype = np.dtype(args.dtype)

    # SPD system: (A + Aᵀ)/2 of a diagonally dominant random matrix
    a = generate.diag_plus_random(args.m, nnz_per_row=8, seed=1)
    rows = np.repeat(np.arange(a.m), a.row_lengths)
    sym = st.CsrMatrix.from_coo(
        a.m, a.n, np.concatenate([rows, a.colidx]),
        np.concatenate([a.colidx, rows]),
        np.concatenate([a.vals, a.vals]) * 0.5).astype(dtype)
    h = st.create_handle(sym, device=args.device)
    b = np.random.default_rng(2).standard_normal(sym.n).astype(dtype)
    tol = (1e-5 if dtype == np.float32 else 1e-10) * float(np.linalg.norm(b))

    for name in ("cg", "bicgstab"):
        solvers.host_syncs = 0
        t0 = time.perf_counter()
        x, res, iters = getattr(solvers, name)(h, b, tol=tol)
        _wait(args.device)
        dt = time.perf_counter() - t0
        ax = st.spmv_golden(sym.astype(np.float64),
                            x.cpu().numpy().astype(np.float64))
        print(f"{name}: {h!r}: {iters} iterations, residual {res:.2e}, "
              f"|Ax-b| {np.linalg.norm(ax - b):.2e}, "
              f"{solvers.host_syncs} host reads, {dt * 1e3:.1f} ms")

    lam, v = solvers.power_iteration(h, iters=50)
    print(f"power iteration: lambda_max ~ {lam:.6f} (v on {v.device})")


if __name__ == "__main__":
    main()
