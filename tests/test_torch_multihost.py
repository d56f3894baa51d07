"""The port's multi-host layer (spmv_tpu_torch/parallel/multihost.py and
the multi-process paths of parallel/mesh.py) on two processes over gloo on
the CPU, in the manner of tests/test_multihost.py.

Two ranks of two shards each (``global_mesh_1d(device="cpu",
local_shards=2)``: four shards, so the halo ring crosses between the ranks
and also stays inside one) run every mesh plan kind at a small size: the
scan in its three x modes on test_multihost.py's matrix, DIA (halo,
allgather), SELL-8W (allgather, halo; f32 and f64), SELL-8D (halo), the
column plan on tests/test_torch_dist_auto.py's ``large_n``, and
``build_dist_auto`` on that file's ``webbase100k`` (the graph plan),
``powerlaw`` and ``halo_stragglers`` (the straggler stream).  Each worker
imports only torch and spmv_tpu_torch and writes its y to a file.

Held: the two ranks' y are bit-identical, and bit-identical to the port's
single-controller plan on ``make_mesh_1d(4, device="cpu")`` (the
collectives move the same blocks and add the partials in the same order);
each is within tests/test_torch_dist.py's bounds of the JAX package's plan
on 4 of the conftest's virtual CPU devices (the scan held to
``spmv_golden`` at rtol 1e-9, as test_multihost.py holds it; the
``build_dist_auto`` plans, as tests/test_torch_dist_auto.py holds them, by
the port's executor on the JAX plan's own arrays, bit for bit).  Each
worker has a time limit and is killed past it.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from spmv_tpu import parallel as jpar
from spmv_tpu.oracle import spmv_golden
from spmv_tpu.parallel import multihost as j_multihost
from spmv_tpu.types import CsrMatrix as JaxCsr
from spmv_tpu_torch import convert, parallel as tpar
from spmv_tpu_torch.parallel import multihost
from spmv_tpu_torch.parallel.mesh import Mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the cases both ranks run, as source: the workers exec it without jax,
#: this module for the single-controller and JAX plans
CASES_SRC = r'''
import numpy as np
from spmv_tpu_torch.io import generate
from spmv_tpu_torch.types import CsrMatrix


def _scan_matrix():
    # tests/test_multihost.py's matrix
    return generate.banded(4096, 4096, 8, dtype=np.float64, seed=3)


def _square(dtype=np.float32):
    # tests/test_torch_dist.py's clustered square matrix
    a = generate.clustered(8192, 8192, 8, spread=200, dtype=np.float32,
                           seed=6, exact=False)
    if dtype == np.float64:
        vals = np.random.default_rng(5).standard_normal(a.nnz)
        a = CsrMatrix(a.m, a.n, a.rowptr, a.colidx, vals)
    return a


def _banded_with_stragglers():
    # tests/test_torch_dist_auto.py's halo_stragglers
    a = generate.banded(6000, 6000, 3, dtype=np.float32, seed=9)
    rng = np.random.default_rng(10)
    k = a.nnz // 1000
    rows = rng.integers(0, 3000, k)
    cols = np.minimum(rows + 3000 + rng.integers(0, 2500, k), a.n - 1)
    r_all = np.concatenate([np.repeat(np.arange(a.m), a.row_lengths), rows])
    c_all = np.concatenate([np.asarray(a.colidx, dtype=np.int64), cols])
    v_all = np.concatenate([np.asarray(a.vals),
                            rng.standard_normal(k).astype(np.float32)])
    return CsrMatrix.from_coo(a.m, a.n, r_all, c_all, v_all)


#: name -> (matrix, builder of spmv_tpu_torch.parallel, its keywords, the
#: (kind, x mode) build_dist_auto must give, or None)
CASES = {
    "scan_replicated": (_scan_matrix, "build_dist_plan",
                        dict(x_mode="replicated"), None),
    "scan_allgather": (_scan_matrix, "build_dist_plan",
                       dict(x_mode="allgather"), None),
    "scan_halo": (_scan_matrix, "build_dist_plan", dict(x_mode="halo"),
                  None),
    "dia_halo": (lambda: generate.banded(3000, 3000, 4, seed=1),
                 "build_dist_dia_plan", dict(x_mode="halo"), None),
    "dia_allgather": (lambda: generate.banded(3000, 3000, 4, seed=1),
                      "build_dist_dia_plan", dict(x_mode="allgather"),
                      None),
    "sell8w_allgather": (_square, "build_dist_sell8w_plan",
                         dict(x_mode="allgather"), None),
    "sell8w_halo": (_square, "build_dist_sell8w_plan", dict(x_mode="halo"),
                    None),
    "sell8w_f64_allgather": (lambda: _square(np.float64),
                             "build_dist_sell8w_plan",
                             dict(x_mode="allgather"), None),
    "sell8w_f64_halo": (lambda: _square(np.float64),
                        "build_dist_sell8w_plan", dict(x_mode="halo"),
                        None),
    "sell8d_halo": (_square, "build_dist_sell8d_plan",
                    dict(x_mode="halo", nw=1), None),
    "cols_large_n": (lambda: generate.random_uniform(
        30_000, 2_500_000, 64, dtype=np.float32, seed=20),
        "build_dist_auto", {}, ("sell8d_cols", "col-shards")),
    "auto_webbase100k": (lambda: generate.webbase_like(
        100_000, 100_000, 310_000, dtype=np.float32, seed=11),
        "build_dist_auto", {}, ("graph", "replicated/replicated")),
    "auto_powerlaw": (lambda: generate.power_law(
        20_000, 20_000, 16 * 20_000, dtype=np.float32, seed=4),
        "build_dist_auto", {}, ("hybrid", "replicated/replicated")),
    "auto_halo_stragglers": (_banded_with_stragglers, "build_dist_auto", {},
                             ("dia", "halo")),
}


def case_x(a):
    """test_multihost.py's x."""
    return generate.make_x(a.n, a.dtype, kind="normal", seed=4)
'''

_ns = {}
exec(CASES_SRC, _ns)
CASES, case_x = _ns["CASES"], _ns["case_x"]

WORKER = r'''
import json
import sys

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
import numpy as np
import torch

torch.set_num_threads(2)
from spmv_tpu_torch import parallel
from spmv_tpu_torch.parallel import mesh as pm
from spmv_tpu_torch.parallel.multihost import (global_mesh_1d,
                                               init_distributed,
                                               is_multiprocess)

init_distributed(init_method=f"tcp://localhost:{port}", world_size=2,
                 rank=rank, device="cpu")
init_distributed()                  # idempotent: the group is up
assert is_multiprocess()
assert torch.distributed.get_backend() == "gloo"
mesh = global_mesh_1d(device="cpu", local_shards=2)
assert mesh.ranks == (0, 0, 1, 1), mesh.ranks
assert mesh.devices == (torch.device("cpu"),) * 4
ns = {}
exec(open(sys.argv[4]).read(), ns)


def leaves(plan):
    parts = getattr(plan, "parts", None)
    return ([v for v in parts.values() if hasattr(v, "mesh")]
            if parts is not None else [plan])


sent = {}
for name, (make, build, kw, route) in ns["CASES"].items():
    a = make()
    plan = getattr(parallel, build)(a, mesh, **kw)
    if route is not None:
        assert (plan.kind, plan.x_mode) == route, (name, plan.kind,
                                                   plan.x_mode)
    for leaf in leaves(plan):
        # each rank placed only its own shards
        for f in ("streams", "data", "vals_pad"):
            shards = getattr(leaf, f, None)
            if shards is not None:
                assert [s is not None for s in shards] == [
                    r == rank for r in mesh.ranks], (name, f)
    before = pm.sent_bytes
    y = plan(torch.from_numpy(ns["case_x"](a)))
    sent[name] = pm.sent_bytes - before
    np.save(f"{out}/{name}.rank{rank}.npy", y.numpy())
with open(f"{out}/sent.rank{rank}.json", "w") as f:
    json.dump(sent, f)
bad = sorted(m for m in sys.modules if m == "jax" or m == "spmv_tpu"
             or m.startswith(("jax.", "jaxlib", "spmv_tpu.")))
assert not bad, bad
print(f"rank{rank} DONE", flush=True)
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(script, args, timeout):
    """Start one process per argument list; wait for each within
    ``timeout`` seconds, killing them all past it."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, str(script), *a],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
             for a in args]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    """Both ranks' y of every case, and the bytes each rank sent."""
    tmp = tmp_path_factory.mktemp("multihost")
    (tmp / "cases.py").write_text(CASES_SRC)
    (tmp / "worker.py").write_text(WORKER)
    port = str(_free_port())
    res = _run(tmp / "worker.py",
               [[str(r), port, str(tmp), str(tmp / "cases.py")]
                for r in range(2)], timeout=240)
    for r, (rc, out) in enumerate(res):
        assert rc == 0 and f"rank{r} DONE" in out, \
            f"rank {r} exited {rc}:\n{out[-3000:]}"
    return tmp


def _jax(a):
    return JaxCsr(a.m, a.n, a.rowptr, a.colidx, a.vals)


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_the_single_controller_plan(ranks_out, name):
    make, build, kw, _route = CASES[name]
    a = make()
    x = case_x(a)
    y0, y1 = (np.load(ranks_out / f"{name}.rank{r}.npy") for r in (0, 1))
    assert y0.dtype == y1.dtype == a.vals.dtype and y0.shape == (a.m,)
    np.testing.assert_array_equal(y0, y1)
    single = getattr(tpar, build)(a, tpar.make_mesh_1d(4, device="cpu"),
                                  **kw)
    y = single(torch.from_numpy(x)).numpy()
    assert y.dtype == y0.dtype
    np.testing.assert_array_equal(y0, y)
    sent = [json.loads((ranks_out / f"sent.rank{r}.json").read_text())[name]
            for r in (0, 1)]
    # every plan moves x blocks or outputs between the ranks
    assert min(sent) > 0


def _jax_plan(name, a):
    _make, build, kw, _route = CASES[name]
    interp = {} if build in ("build_dist_plan", "build_dist_dia_plan") \
        else {"interpret": True}
    return getattr(jpar, build)(_jax(a), jpar.make_mesh_1d(4), **kw,
                                **interp)


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_within_bounds_of_jax(ranks_out, name, x64):
    a = CASES[name][0]()
    x = case_x(a)
    y = np.load(ranks_out / f"{name}.rank0.npy").astype(np.float64)
    jplan = _jax_plan(name, a)
    ref = spmv_golden(_jax(a).astype(np.float64), x.astype(np.float64))
    if name.startswith("scan"):
        np.testing.assert_allclose(y, ref, rtol=1e-9)
    elif CASES[name][1] == "build_dist_auto":
        assert (jplan.kind, jplan.x_mode) == CASES[name][3]
        mesh = tpar.make_mesh_1d(4, device="cpu")
        y_ref = convert.dist_plan_from_reference(jplan, mesh)(
            torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(y_ref, y.astype(y_ref.dtype))
    else:
        # tests/test_torch_dist.py's bounds, scaled by max |y|
        want = np.asarray(jplan(x), dtype=np.float64)
        scale = max(np.abs(ref).max(), 1.0)
        df = a.vals.dtype == np.float64
        if df:
            np.testing.assert_allclose(y / scale, ref / scale, atol=1e-12)
        np.testing.assert_allclose(y / scale, want / scale,
                                   atol=2e-6 if df else 3e-6)


@pytest.fixture
def x64():
    import jax
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", was)


# -- the entry points --------------------------------------------------------

def test_multihost_exports_the_reference_names():
    assert multihost.__all__ == j_multihost.__all__
    assert tpar.multihost is multihost


def test_no_group_is_one_process():
    assert not multihost.is_multiprocess()
    mesh = multihost.global_mesh_1d(device="cpu", local_shards=3)
    assert mesh == tpar.make_mesh_1d(3, device="cpu")
    assert mesh.ranks is None and mesh.home == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            multihost.global_mesh_1d()


def test_mesh_ranks_validated():
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="as many times"):
        Mesh((cpu,) * 3, ranks=(0, 0, 1))
    with pytest.raises(ValueError, match="one rank a device"):
        Mesh((cpu,) * 2, ranks=(0, 0, 1))


ENV_WORKER = r'''
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from spmv_tpu_torch import parallel
from spmv_tpu_torch.io import generate
from spmv_tpu_torch.parallel.multihost import (global_mesh_1d,
                                               init_distributed,
                                               is_multiprocess)

# a backend that fails to start raises, and nothing else starts
try:
    init_distributed(init_method="tcp://localhost:" + sys.argv[1],
                     world_size=1, rank=0, backend="nccl", device="cpu")
except (RuntimeError, ValueError) as e:
    print("nccl refused:", str(e).splitlines()[0])
else:
    raise AssertionError("nccl started on a CPU-only build")
assert not dist.is_initialized()
# the torchrun environment: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK
init_distributed(device="cpu")
assert dist.is_initialized() and dist.get_backend() == "gloo"
assert (dist.get_world_size(), dist.get_rank()) == (1, 0)
init_distributed(device="cpu")      # idempotent
assert not is_multiprocess()
mesh = global_mesh_1d(device="cpu", local_shards=3)
assert mesh.ranks == (0, 0, 0)
# a one-rank group runs the collectives' multi-process path
a = generate.clustered(3000, 3000, 6, spread=100, dtype=np.float32, seed=2)
x = torch.from_numpy(generate.make_x(a.n, a.dtype, kind="normal", seed=1))
single = parallel.make_mesh_1d(3, device="cpu")
for mode in ("allgather", "halo"):
    y = parallel.build_dist_sell8w_plan(a, mesh, x_mode=mode)(x)
    want = parallel.build_dist_sell8w_plan(a, single, x_mode=mode)(x)
    assert torch.equal(y, want), mode
dist.destroy_process_group()
print("DONE", flush=True)
'''


def test_init_distributed_reads_the_torchrun_environment(tmp_path,
                                                         monkeypatch):
    script = tmp_path / "env_worker.py"
    script.write_text(ENV_WORKER)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    [(rc, out)] = _run(script, [[str(_free_port())]], timeout=120)
    assert rc == 0 and "DONE" in out, out[-3000:]
    assert "nccl refused" in out
