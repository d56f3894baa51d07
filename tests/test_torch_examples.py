"""The port's examples (``examples/torch_solvers.py``,
``examples/torch_tour.py``) run end to end on the CPU at a small size, in
a process that imports no JAX."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("script,args,expect", [
    ("torch_solvers.py", ["--m", "2000"], ["cg:", "bicgstab:",
                                           "power iteration"]),
    ("torch_solvers.py", ["--m", "1500", "--dtype", "float32"],
     ["cg:", "bicgstab:"]),
    ("torch_tour.py", ["--m", "2000"], ["tune picked:", "f64 handle:",
                                        "mtx round trip:", "dist ",
                                        "Method_Dia"]),
])
def test_example_runs_on_cpu(tmp_path, script, args, expect):
    code = ("import runpy, sys\n"
            f"sys.argv = [{script!r}] + sys.argv[1:]\n"
            f"runpy.run_path({os.path.join(ROOT, 'examples', script)!r},"
            " run_name='__main__')\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in"
            " ('jax', 'jaxlib', 'spmv_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code, "--device", "cpu",
                          *args], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    for word in expect:
        assert word in res.stdout, res.stdout
    assert "nan" not in res.stdout.lower()
