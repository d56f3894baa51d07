"""Benchmark + validation suite — the reference harness on a torch device
(the port of ``spmv_tpu/bench/suite.py``).

Reproduces the reference's bench/validation flow (``src/samples/test_spmv.c``):
load or synthesize a matrix, compute a golden y, run every requested method,
check RMSE, and emit CSV rows in the reference's exact schema
(test_spmv.c:146-149)::

    matrix,method,vectorized,threads,nnz,rmse,predeal_ms,avg_ms,GFLOPs_avg,GFLOPs_fastest

Differences from the reference, all deliberate:

* timing is the chained protocol of :mod:`.timing` (CUDA events on the
  card) in place of the reference's 10+100-iteration dispatch loop
  (test_spmv.c:103-125);
* the ``threads`` column is the device count of the handle's device type;
* the external baselines (the role of the MKL bench,
  ``src/samples/mkl_spmv.c``) are scipy CSR on the host and one
  ``torch.sparse_csr_tensor(...) @ x`` on the device (cuSPARSE on the
  card), reported as pseudo-methods ``ScipyCsr`` / ``TorchCsr``; the port's
  ``spmv`` never calls the latter.

A planning refusal (``ValueError``, ``NotImplementedError``), or a plan
the card cannot hold (``torch.cuda.OutOfMemoryError`` while planning,
placing, on the first call or in timing; the cache is emptied), is
reported as a comment line and the sweep goes on, as the JAX suite's
"report, keep sweeping"; any other error of the card propagates.

CLI::

    python -m spmv_tpu_torch.bench.suite builtin:banded1m builtin:uniform100k
    python -m spmv_tpu_torch.bench.suite path/to/matrix.mtx --methods AUTO,DIA
    python -m spmv_tpu_torch.bench.suite builtin:uniform10k --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Iterable, List, Optional

import numpy as np
import torch

from ..formats import _bf16
from ..types import CsrMatrix, Method, METHOD_NAMES, VECTORIZED_NAMES
from ..oracle import rmse as _rmse, spmv_golden
from .timing import (empty_cache_after_oom, is_cuda_error, synchronize,
                     time_spmv, time_spmv_chain)

__all__ = ["BUILTIN_MATRICES", "load_any", "bench_matrix", "main",
           "CSV_HEADER"]

CSV_HEADER = ("matrix,method,vectorized,threads,nnz,rmse,predeal_ms,"
              "avg_ms,GFLOPs_avg,GFLOPs_fastest")

#: Synthetic stand-ins for the BASELINE.md configs (no SuiteSparse egress):
#: the JAX suite's generator calls and seeds.
BUILTIN_MATRICES = {
    "banded1m": lambda dtype: _gen("banded", dtype, 1_000_000),
    "banded4m": lambda dtype: _gen("banded", dtype, 4_000_000),
    "banded100k": lambda dtype: _gen("banded", dtype, 100_000),
    "uniform100k": lambda dtype: _gen("uniform", dtype, 100_000),
    "powerlaw100k": lambda dtype: _gen("powerlaw", dtype, 100_000),
    "uniform10k": lambda dtype: _gen("uniform", dtype, 10_000),
    "clustered200k": lambda dtype: _gen("clustered", dtype, 200_000),
    "blocky": lambda dtype: _gen("blocky", dtype, 0),
    "webbase1m": lambda dtype: _gen("webbase", dtype, 1_000_000),
    "scattered4m": lambda dtype: _gen("scattered4m", dtype, 4_000_000),
}


def _gen(kind: str, dtype, m: int) -> CsrMatrix:
    from ..io import generate
    if _bf16.is_bf16(dtype):
        # generate in f32, then round (CsrMatrix.astype), as chip_smoke.py
        # casts its bf16 families
        return _gen(kind, np.float32, m).astype(dtype)
    if kind == "banded":
        return generate.banded(m, m, 4, dtype=dtype, seed=7)
    if kind == "uniform":
        return generate.random_uniform(m, m, 40, dtype=dtype, seed=42)
    if kind == "powerlaw":
        return generate.power_law(m, m, 40 * m, dtype=dtype, seed=2)
    if kind == "clustered":
        return generate.clustered(m, m, 32, spread=512, dtype=dtype, seed=9)
    if kind == "webbase":
        return generate.webbase_like(m, m, 3_100_000, dtype=dtype, seed=11)
    if kind == "scattered4m":
        return generate.random_uniform(m, 262_144, 8, dtype=dtype, seed=13)
    if kind == "blocky":
        return generate.block_random(16, 16, blocks_per_row=4, fill=0.4,
                                     dtype=dtype, seed=5)
    raise ValueError(kind)


def load_any(spec: str, dtype=np.float32) -> tuple:
    """'builtin:<name>' or a MatrixMarket path → (display_name, CsrMatrix)."""
    if spec.startswith("builtin:"):
        name = spec.split(":", 1)[1]
        return name, BUILTIN_MATRICES[name](dtype)
    from ..io.mmio import load_matrix
    return spec, load_matrix(spec, dtype=dtype)


def _row(matrix, method_name, vec_name, threads, nnz, rmse, predeal_ms,
         avg_ms, gflops_avg, gflops_best) -> str:
    return (f"{matrix},{method_name},{vec_name},{threads},{nnz},"
            f"{rmse:.6g},{predeal_ms:.3f},{avg_ms:.6f},"
            f"{gflops_avg:.6f},{gflops_best:.6f}")


def bench_matrix(name: str, a: CsrMatrix,
                 methods: Iterable[Method],
                 iters: int = 10, repeats: int = 2,
                 external: bool = False,
                 split_predeal: bool = False,
                 out=None, device="cuda") -> List[str]:
    """Bench one matrix across methods on ``device``; print (to ``out``,
    by default ``sys.stdout``) + return CSV rows.

    ``split_predeal`` appends ``pack_ms,transfer_ms`` columns (the
    host-pack vs device-transfer split of the predeal, measured via
    ``predeal_profile``); the default keeps the reference's exact schema
    (test_spmv.c:146-149).
    """
    from ..handle import _resolve_device, _torch_dtype, create_handle
    from ..utils.profiling import predeal_profile

    out = sys.stdout if out is None else out
    dev = _resolve_device(device)
    # x in the matrix's type, as the JAX suite draws it (bf16-rounded for a
    # bf16 matrix, passed as f32)
    x = np.random.default_rng(0).standard_normal(a.n)
    x = (_bf16.round_f32(x) if a.dtype == torch.bfloat16
         else x.astype(a.dtype))
    golden = spmv_golden(a.astype(np.float64), x.astype(np.float64))
    xt = torch.from_numpy(x).to(dev, _torch_dtype(a.dtype))
    threads = torch.get_device_module(dev.type).device_count()
    rows = []

    for method in methods:
        t0 = time.perf_counter()
        try:
            if split_predeal:
                with predeal_profile() as laps:
                    h = create_handle(a, method=method, device=dev)
            else:
                laps = {"transfer_s": 0.0}
                h = create_handle(a, method=method, device=dev)
        except (ValueError, NotImplementedError,
                torch.cuda.OutOfMemoryError) as e:
            empty_cache_after_oom(e)
            print(f"# {name},{METHOD_NAMES[Method(method)]}: "
                  f"handle failed: {e}", file=out, flush=True)
            continue
        predeal_ms = (time.perf_counter() - t0) * 1e3
        try:
            y = h._bound(xt).cpu().numpy()      # first call + correctness
            rmse = _rmse(y, golden)
            t1 = time.perf_counter()            # warm second call: the
            h._bound(xt)                        # per-call magnitude
            synchronize(dev)
            exec_s = time.perf_counter() - t1
            # chained-k protocol: avg = inclusive T(k)/k, fastest =
            # marginal (T(k)-T(1))/(k-1); plans slower than 0.2 s a call
            # keep the chain short, as the JAX suite does
            k_eff = 8 if exec_s < 0.2 else 2
            iters_eff = iters if exec_s < 0.2 else max(2, iters // 5)
            r = time_spmv_chain(h._bound, xt, iters=iters_eff, k=k_eff,
                                repeats=repeats)
        except torch.cuda.OutOfMemoryError as e:
            method_name, h = h.method_name, None
            empty_cache_after_oom(e)
            print(f"# {name},{method_name}: exec/timing failed: "
                  f"{str(e).splitlines()[0][:120]}", file=out, flush=True)
            continue
        avg, best = r["inclusive"], r["marginal"]
        row = _row(name, h.method_name, VECTORIZED_NAMES[h.vectorized],
                   threads, a.nnz, rmse, predeal_ms, avg * 1e3,
                   2 * a.nnz / avg / 1e9, 2 * a.nnz / best / 1e9)
        if split_predeal:
            t_ms = laps["transfer_s"] * 1e3
            row += f",{predeal_ms - t_ms:.3f},{t_ms:.3f}"
        print(row, file=out, flush=True)
        rows.append(row)

    if external:
        ext = _external_baselines(name, a, x, xt, golden, iters, out)
        if split_predeal:          # keep the CSV rectangular
            ext = [r + ",," for r in ext]
        rows += ext
    return rows


def _external_baselines(name, a, x, xt, golden, iters, out) -> List[str]:
    """ScipyCsr (host CPU) and TorchCsr (the device) — the MKL-bench
    role."""
    rows = []
    try:
        import scipy.sparse as sp
        s = sp.csr_matrix((_bf16.as_float(a.vals), a.colidx, a.rowptr),
                          shape=(a.m, a.n))
        t0 = time.perf_counter()
        n_it = max(3, iters)
        for _ in range(n_it):
            y = s @ x
        dt = (time.perf_counter() - t0) / n_it
        rows.append(_row(name, "ScipyCsr", "VECTOR_NONE", 1, a.nnz,
                         _rmse(y, golden), 0.0, dt * 1e3,
                         2 * a.nnz / dt / 1e9, 2 * a.nnz / dt / 1e9))
        print(rows[-1], file=out, flush=True)
    except ImportError as e:
        print(f"# ScipyCsr failed: {e}", file=out, flush=True)
    dev = xt.device
    try:
        t0 = time.perf_counter()
        csr = torch.sparse_csr_tensor(
            torch.from_numpy(a.rowptr.astype(np.int64)),
            torch.from_numpy(a.colidx.astype(np.int64)),
            torch.from_numpy(np.ascontiguousarray(
                _bf16.as_float(a.vals))).to(xt.dtype),
            size=(a.m, a.n), check_invariants=False).to(dev)
        synchronize(dev)
        predeal_ms = (time.perf_counter() - t0) * 1e3
        fn = lambda v: csr @ v           # noqa: E731
        y = fn(xt).cpu().numpy()
        dt = time_spmv(fn, xt, iters=max(3, iters // 2), repeats=1)
        rows.append(_row(name, "TorchCsr", "VECTOR_NONE",
                         torch.get_device_module(dev.type).device_count(),
                         a.nnz, _rmse(y, golden), predeal_ms, dt * 1e3,
                         2 * a.nnz / dt / 1e9, 2 * a.nnz / dt / 1e9))
        print(rows[-1], file=out, flush=True)
    except RuntimeError as e:
        # an OOM is a RuntimeError that names CUDA, but not sticky: test
        # for it first
        if not isinstance(e, torch.cuda.OutOfMemoryError) \
                and is_cuda_error(e):
            raise
        empty_cache_after_oom(e)
        print(f"# TorchCsr failed: {str(e).splitlines()[0][:120]}",
              file=out, flush=True)
    return rows


_DEFAULT_METHODS = [Method.SERIAL, Method.PARALLEL, Method.BALANCED,
                    Method.BALANCED2, Method.BALANCED_YID,
                    Method.SELL_C_SIGMA, Method.CSR5, Method.DIA,
                    Method.BCSR, Method.AUTO]


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("matrices", nargs="+",
                   help="builtin:<name> or MatrixMarket paths")
    p.add_argument("--methods", default="AUTO",
                   help="comma list of Method names, or 'all'")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64", "bfloat16"])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--repeats", type=int, default=2)
    p.add_argument("--external", action="store_true",
                   help="also run the ScipyCsr/TorchCsr baselines")
    p.add_argument("--split-predeal", action="store_true",
                   help="append pack_ms,transfer_ms columns (blocks per "
                        "transfer)")
    p.add_argument("--out", default=None,
                   help="also append CSV rows to this file")
    p.add_argument("--device", default="cuda",
                   help="torch device the handles live on (default cuda)")
    args = p.parse_args(argv)

    dtype = (torch.bfloat16 if args.dtype == "bfloat16"
             else np.dtype(args.dtype))
    if args.methods == "all":
        methods = list(_DEFAULT_METHODS)
    else:
        methods = [Method[m.strip().upper()]
                   for m in args.methods.split(",")]

    import os
    header = CSV_HEADER + (",pack_ms,transfer_ms" if args.split_predeal
                           else "")
    print(header, flush=True)
    if args.out and not os.path.exists(args.out):
        with open(args.out, "w") as f:
            f.write(header + "\n")
    for spec in args.matrices:
        name, a = load_any(spec, dtype=dtype)
        rows = bench_matrix(name, a, methods, iters=args.iters,
                            repeats=args.repeats, external=args.external,
                            split_predeal=args.split_predeal,
                            device=args.device)
        if args.out:
            # append per matrix so a crash mid-sweep loses nothing
            with open(args.out, "a") as f:
                for row in rows:
                    f.write(row + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
