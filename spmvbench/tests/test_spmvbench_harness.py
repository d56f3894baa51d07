"""The harness end to end on the CPU at small sizes: a run of each cell, the
files it finds by name, the faults and the control that ``correct`` has to
catch, what it may import, and the command without a card."""

import ast
import json
import os
import subprocess
import sys
import time

import pytest
import torch

import spmv_tpu_torch
from spmvbench import core
from spmvbench.reference import plain

CELLS = ["hpcg-104.cg50", "graph500-s19.pagerank", "hpcg-104.spmv-chain"]
REPO = os.path.dirname(core.ROOT)


def run(tiny, workload, trace=False, seconds=0.3):
    base, root, bench = tiny
    return core.run_cell(bench, workload, 2 ** 31 + 11, seconds, trace,
                         "cpu", time.perf_counter(), base=base, root=root,
                         log=open(os.devnull, "w"))


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct(tiny, workload, trace):
    out = run(tiny, workload, trace)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    bench = tiny[2]
    if not trace:
        want = {m["name"] for m in bench["end_to_end"]
                if core.applies(m, workload)}
        assert set(out["metrics"]) == want
        assert all(v["value"] > 0 for v in out["metrics"].values())
    else:
        # the CPU has no device trace: the device readers return nothing,
        # the program's spans and counters are read
        want = {m["name"] for m in bench["per_layer"]
                if core.applies(m, workload)
                and m["source"] != "device_trace"}
        assert set(out["metrics"]) == want
        assert "breakdown" in out


def test_files_added_by_name(tiny):
    """A configuration, a traffic mix, a cell's limits and a per-layer
    metric added as new files, with entries, and no edit to a file."""
    base, root, bench = tiny
    cfg = core.read_json(os.path.join(base, "spmvbench/configs/hpcg-104.json"))
    cfg.update(name="hpcg-8x12x10", nx=8, ny=12, nz=10)
    with open(os.path.join(root, "configs", "hpcg-8x12x10.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "traffic", "cg5.json"), "w") as f:
        json.dump({"loop": "cg", "maxiter": 5, "tol": 0.0, "rhs_pool": 3,
                   "samples": 2, "warm_units": 1, "traced_units": 2}, f)
    with open(os.path.join(root, "limits", "hpcg-8x12x10.cg5.json"),
              "w") as f:
        json.dump({"x_gap": 1e-10, "res_gap": 1e-10}, f)
    with open(os.path.join(root, "metrics", "units_traced.py"), "w") as f:
        f.write("def read(rec):\n    return rec['attempted']\n")
    bench["configs"].append({"name": "hpcg-8x12x10", "source": "test",
                             "file": "spmvbench/configs/hpcg-8x12x10.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "hpcg-8x12x10.cg5",
                               "config": "hpcg-8x12x10", "traffic": "cg5",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "units_traced", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "solver", "moves": "solve_ms",
                               "workloads": ["hpcg-8x12x10.cg5"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("solve_ms", "solve_ms_p95"):
            m["workloads"].append("hpcg-8x12x10.cg5")
    out = run((base, root, bench), "hpcg-8x12x10.cg5", trace=True)
    assert out["correct"] is True
    assert out["metrics"]["units_traced"]["value"] == out["attempted"]
    out = run((base, root, bench), "hpcg-8x12x10.cg5")
    assert out["metrics"]["solve_ms"]["value"] > 0


def _break(monkeypatch, fault):
    """Break every handle's product underneath the harness."""
    create = spmv_tpu_torch.create_handle

    def broken_create(*args, **kwargs):
        h = create(*args, **kwargs)
        inner = h._bound

        def bound(x):
            if fault == "unchanged":        # a step returns its state
                return x.clone()
            y = inner(x)
            if fault == "half":             # half the rows left out
                y[y.numel() // 2:] = 0
            elif fault == "altered":        # one answer altered
                i = int(y.abs().argmax())
                y[i] = y[i] * (1 + 1e-3)
            return y
        h._bound = bound
        return h

    monkeypatch.setattr(spmv_tpu_torch, "create_handle", broken_create)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_faults_fail(tiny, monkeypatch, workload, fault):
    """Each fault a one-card cell can have makes ``correct`` false (there
    is no exchange between cards to leave out)."""
    _break(monkeypatch, fault)
    out = run(tiny, workload)
    assert out["correct"] is False, (fault, out["checks"])


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_program_passes(tiny, workload):
    """The reference one precision down, put in the program's place, fails
    one of the cell's limits; the program's own outputs pass them."""
    base, root, bench = tiny
    c = core.cell_files(bench, workload, base, root)
    cfg, limits = c.cfg, c.limits
    a = c.gen.generate(cfg, 5)
    h = spmv_tpu_torch.create_handle(spmv_tpu_torch.CsrMatrix(
        a["m"], a["n"], a["rowptr"], a["colidx"], a["vals"]),
        device="cpu")
    loop = c.loop.make(spmv_tpu_torch, h, a, cfg, c.traffic, 5, "cpu")
    items = [loop.unit(None)[2] for _ in range(3)]
    ref = plain.Csr(a, torch.float64, "cpu")
    low = plain.Csr(a, plain.LOWER[getattr(torch, cfg["dtype"])], "cpu")
    for it in items:
        want = loop.reference(ref, it)
        assert all(v <= limits[k] for k, v in loop.gaps(it, want).items())
        control = loop.gaps(loop.reference(low, it), want)
        assert any(v > limits[k] for k, v in control.items()), control


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    for d, _sub, files in os.walk(core.ROOT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_imports():
    """No module of the benchmark imports JAX or the JAX package, top-level
    names compared whole (``spmv_tpu_torch`` is the measured program)."""
    for path in _sources():
        bad = set(_imports(path)) & set(core.FORBIDDEN)
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_port():
    for path in _sources():
        if os.sep + "reference" + os.sep in path:
            assert not set(_imports(path)) & {"spmv_tpu_torch", "spmv_tpu"}


def test_forbidden_modules_compared_whole(monkeypatch):
    assert "spmv_tpu_torch" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in core.forbidden_modules()


def _command(cwd, env):
    return subprocess.run(
        [sys.executable, "spmvbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
        env=env, capture_output=True, text=True, timeout=120)


def test_command_fails_without_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = _command(REPO, env)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA card" in res.stderr


def test_command_fails_with_benchmark_alone(tmp_path):
    """In a directory that holds only ``BENCHMARK.json`` and the
    benchmark's folder, the command fails and prints no result."""
    import shutil
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(core.ROOT, tmp_path / "spmvbench")
    res = _command(str(tmp_path), dict(os.environ, PYTHONPATH=""))
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_card(card, workload):
    """Each cell once on the card, at its own size, a short window."""
    res = subprocess.run(
        [sys.executable, "spmvbench/run.py", "--workload", workload,
         "--seed", "3", "--seconds", "2", "--trace", "0"], cwd=REPO,
        capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
