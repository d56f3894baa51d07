"""The plain reference against dense numpy at small sizes, and its control
one precision down."""

import numpy as np
import pytest
import torch

from spmvbench.generators import hpcg27, kronecker
from spmvbench.reference import plain


def dense_of(a):
    d = np.zeros((a["m"], a["n"]))
    rows = np.repeat(np.arange(a["m"]), np.diff(a["rowptr"]))
    d[rows, a["colidx"]] = a["vals"]
    return d


@pytest.fixture(scope="module")
def hpcg():
    return hpcg27.generate({"nx": 6, "ny": 5, "nz": 4, "dtype": "float64"}, 0)


@pytest.fixture(scope="module")
def graph():
    return kronecker.generate({"scale": 8, "edgefactor": 16,
                               "initiator": [0.57, 0.19, 0.19, 0.05],
                               "dtype": "float32"}, 7)


def test_product(hpcg, graph):
    for a in (hpcg, graph):
        x = np.random.default_rng(1).standard_normal(a["n"])
        y = plain.Csr(a, torch.float64, "cpu")(torch.from_numpy(x))
        np.testing.assert_allclose(y.numpy(), dense_of(a) @ x, rtol=1e-13,
                                   atol=1e-13)


def test_cg(hpcg):
    d = dense_of(hpcg)
    b = np.random.default_rng(2).standard_normal(hpcg["n"])
    x, res = plain.cg(plain.Csr(hpcg, torch.float64, "cpu"),
                      torch.from_numpy(b), 12)
    # numpy statement of the same recurrence
    xw = np.zeros_like(b)
    r = b - d @ xw
    p = r.copy()
    rs = r @ r
    for _ in range(12):
        ap = d @ p
        alpha = rs / (p @ ap)
        xw = xw + alpha * p
        r = r - alpha * ap
        rs_new = r @ r
        p = r + rs_new / rs * p
        rs = rs_new
    np.testing.assert_allclose(x.numpy(), xw, rtol=1e-11, atol=1e-12)
    assert float(res) == pytest.approx(np.sqrt(rs), rel=1e-9)
    # and it solves: many iterations reach the dense solve
    x, _ = plain.cg(plain.Csr(hpcg, torch.float64, "cpu"),
                    torch.from_numpy(b), 200)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(d, b), rtol=1e-8,
                               atol=1e-10)


def test_pagerank(graph):
    d = dense_of(graph)
    n = graph["n"]
    r0 = np.random.default_rng(3).random(n)
    r0 /= r0.sum()
    got = plain.pagerank(plain.Csr(graph, torch.float64, "cpu"),
                         torch.from_numpy(r0), 0.85, 20)
    r = r0
    for _ in range(20):
        r = (1 - 0.85) / n + 0.85 * (d @ r)
    np.testing.assert_allclose(got.numpy(), r, rtol=1e-12, atol=1e-15)


def test_chain(hpcg):
    d = dense_of(hpcg)
    x0 = np.random.default_rng(4).standard_normal(hpcg["n"])
    got = plain.chain(plain.Csr(hpcg, torch.float64, "cpu"),
                      torch.from_numpy(x0), 7)
    x = x0
    for _ in range(7):
        y = d @ x
        x = y / 2.0 ** np.floor(np.log2(np.abs(y).max()))
    np.testing.assert_allclose(got.numpy(), x, rtol=1e-12, atol=1e-13)
    assert 1.0 <= float(got.abs().max()) < 2.0


def test_gaps():
    want = torch.tensor([1.0, -2.0, 4.0], dtype=torch.float64)
    assert plain.rel_gap(want, want) == 0.0
    assert plain.rel_gap(want + torch.tensor([0, 0, 0.004]), want) \
        == pytest.approx(1e-3)
    # a power of two apart is no gap in direction
    assert plain.direction_gap(want * 2, want) == 0.0
    assert plain.direction_gap(want * torch.tensor([1, 1, 1.5]), want) > 0.1


def test_control_is_lower(hpcg, graph):
    """The control computes one precision below the configuration's."""
    assert plain.LOWER[torch.float64] == torch.float32
    assert plain.LOWER[torch.float32] == torch.bfloat16
    x = torch.from_numpy(np.random.default_rng(5).random(graph["n"]))
    low = plain.Csr(graph, torch.bfloat16, "cpu")(x)
    assert low.dtype == torch.bfloat16
    ref = plain.Csr(graph, torch.float64, "cpu")(x)
    assert plain.rel_gap(low, ref) > 1e-4
