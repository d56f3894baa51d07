"""Shared fixtures of the benchmark's tests.  Run them from the root of the
repository: ``python -m pytest spmvbench/tests -q`` (on a machine with a
card, the ``card`` tests run too)."""

import json
import os
import shutil

import pytest

from spmvbench import core

#: small stand-ins for the configurations, for the CPU
TINY = {"hpcg-104": {"nx": 16, "ny": 16, "nz": 16},
        "graph500-s19": {"scale": 11}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (CUDA); skips elsewhere")


@pytest.fixture
def card():
    """Skips the test where there is no CUDA card (decided here, when the
    test runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def tiny(tmp_path):
    """A copy of the benchmark under ``tmp_path`` (``BENCHMARK.json`` and
    ``spmvbench/`` without its tests) with each configuration cut to a CPU
    size.  Returns (base, root, bench)."""
    base = str(tmp_path)
    root = os.path.join(base, "spmvbench")
    shutil.copytree(core.ROOT, root, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    shutil.copy(os.path.join(os.path.dirname(core.ROOT), "BENCHMARK.json"),
                base)
    bench = core.read_json(os.path.join(base, "BENCHMARK.json"))
    for c in bench["configs"]:
        path = os.path.join(base, c["file"])
        cfg = core.read_json(path)
        cfg.update(TINY[c["name"]])
        with open(path, "w") as f:
            json.dump(cfg, f)
    return base, root, bench
