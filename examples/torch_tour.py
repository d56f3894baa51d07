"""Feature tour of the PyTorch port: every major capability in one script
(the counterpart of ``examples/tour.py``).

Run:  python examples/torch_tour.py                 # on the card
      python examples/torch_tour.py --device cpu --m 2000
"""

import argparse
import os
import sys
import tempfile

# allow `python examples/<name>.py` without installing the package
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

import spmv_tpu_torch as st
from spmv_tpu_torch.io import generate, mmio


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--m", type=int, default=100_000,
                   help="rows of the zoo's matrices")
    args = p.parse_args(argv)
    dev, m = args.device, args.m

    # -- structures and the inspector ------------------------------------
    zoo = {
        "banded": generate.banded(m, m, 4, dtype=np.float32),
        "clustered": generate.clustered(m, m, 24, spread=300,
                                        dtype=np.float32),
        "blocky": generate.block_random(4, 4, 2, fill=0.4,
                                        dtype=np.float32),
        "scattered": generate.random_uniform(m, m, 30, dtype=np.float32),
    }
    for name, a in zoo.items():
        feats = st.featurize(a)
        h = st.create_handle(a, device=dev)            # Method.AUTO
        x = np.random.default_rng(0).standard_normal(a.n).astype(np.float32)
        y = st.spmv(h, torch.from_numpy(x).to(dev)).cpu().numpy()
        ref = st.spmv_golden(a.astype(np.float64), x.astype(np.float64))
        err = np.abs(y - ref).max() / max(np.abs(ref).max(), 1)
        print(f"{name:10s} -> {h!r}  ndiags={feats.ndiags} relerr={err:.1e}")

    # -- measurement-based tuning ----------------------------------------
    h, timings = st.tune(zoo["banded"], iters=3, repeats=1, device=dev)
    print("tune picked:", h.method_name,
          {k: f"{v*1e3:.3f}ms" for k, v in timings.items()})

    # -- f64: native f64 on the card --------------------------------------
    a64 = generate.clustered(m, m, 16, spread=250, dtype=np.float64)
    h64 = st.create_handle(a64, method=st.Method.SELL_C_SIGMA, device=dev)
    x64 = np.random.default_rng(2).standard_normal(m)
    y64 = st.spmv(h64, torch.from_numpy(x64).to(dev)).cpu().numpy()
    ref64 = st.spmv_golden(a64, x64)
    print(f"f64 handle: {h64!r}  maxrel="
          f"{np.abs(y64 - ref64).max() / np.abs(ref64).max():.1e}")

    # -- locality reordering ----------------------------------------------
    scramble = np.random.default_rng(1).permutation(m)
    scrambled, _ = st.formats.reorder.reorder_symmetric(zoo["banded"],
                                                        scramble)
    h2 = st.create_handle(scrambled, reorder="rcm", device=dev)
    print("reordered handle:", repr(h2), "perm set:", h2.perm is not None)

    # -- handle lifecycle: clear + re-prep (reference parity) --------------
    h2.clear()
    h2.prepare(st.Method.BALANCED_YID)
    print("re-prepped:", h2.method_name)

    # -- solvers -----------------------------------------------------------
    lam, _ = st.solvers.power_iteration(h64, iters=30)
    print(f"power iteration on the f64 handle: lambda ~ {lam:.4f}")

    # -- Matrix Market I/O with the .npz cache ------------------------------
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "clustered.mtx")
        mmio.write_mtx(path, zoo["clustered"])
        a = mmio.load_matrix(path, cache_dir=os.path.join(d, "cache"))
        b = mmio.load_matrix(path, cache_dir=os.path.join(d, "cache"))
        print(f"mtx round trip: nnz={a.nnz}, reads={mmio.reads}, "
              f"cache hit equal: {np.array_equal(a.vals, b.vals)}")

    # -- mesh plans (4 shards of one device) --------------------------------
    from spmv_tpu_torch import parallel
    mesh = parallel.make_mesh_1d(4, device=dev)
    plan = parallel.build_dist_auto(zoo["banded"].astype(np.float64), mesh)
    y = plan(torch.ones(m, dtype=torch.float64, device=dev))
    print(f"dist {plan.kind} ({plan.x_mode}) on 4 shards: y[:3] = "
          f"{y[:3].tolist()}")

    # -- the CSV suite and the roofline model -------------------------------
    from spmv_tpu_torch.bench import suite
    print(suite.CSV_HEADER)
    suite.bench_matrix("banded", zoo["banded"], [st.Method.AUTO], iters=2,
                       repeats=1, device=dev)
    a = zoo["banded"]
    print("roofline @3350 GB/s (csr model):",
          f"{st.utils.roofline_gflops(a.m, a.n, a.nnz, 3350.0):.1f} GFLOP/s")


if __name__ == "__main__":
    main()
