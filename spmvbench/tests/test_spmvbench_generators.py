"""The generators against direct statements of their sources."""

import numpy as np
import pytest
import torch

from spmvbench import core
from spmvbench.generators import hpcg27, kronecker


def stencil_nnz(nx, ny, nz):
    # each grid line contributes 3n − 2 neighbour pairs, counting itself
    return (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)


def test_hpcg_104_sizes():
    """hpcg-104 is 1,124,864 rows and 29,791,000 nonzeros (= 310³), as the
    configuration states; the count rule holds on generated grids below
    (generating 104³ itself is left to the card)."""
    cfg = core.read_json(f"{core.ROOT}/configs/hpcg-104.json")
    assert cfg["nx"] * cfg["ny"] * cfg["nz"] == cfg["rows"] == 1_124_864
    assert stencil_nnz(cfg["nx"], cfg["ny"], cfg["nz"]) == cfg["nnz"] \
        == 29_791_000 == 310 ** 3


@pytest.mark.parametrize("dims", [(8, 8, 8), (5, 6, 7), (1, 3, 2)])
def test_hpcg_matches_direct_stencil(dims):
    nx, ny, nz = dims
    a = hpcg27.generate({"nx": nx, "ny": ny, "nz": nz,
                         "dtype": "float64"}, 0)
    n = nx * ny * nz
    assert a["m"] == a["n"] == n
    assert a["colidx"].size == stencil_nnz(nx, ny, nz)
    dense = np.zeros((n, n))
    for z in range(nz):
        for y in range(ny):
            for x in range(nx):
                i = (z * ny + y) * nx + x
                for dz in (-1, 0, 1):
                    for dy in (-1, 0, 1):
                        for dx in (-1, 0, 1):
                            zz, yy, xx = z + dz, y + dy, x + dx
                            if 0 <= zz < nz and 0 <= yy < ny and 0 <= xx < nx:
                                j = (zz * ny + yy) * nx + xx
                                dense[i, j] = 26.0 if i == j else -1.0
    got = np.zeros((n, n))
    rows = np.repeat(np.arange(n), np.diff(a["rowptr"]))
    got[rows, a["colidx"]] = a["vals"]
    np.testing.assert_array_equal(got, dense)
    for r in range(n):     # columns ascend in each row
        c = a["colidx"][a["rowptr"][r]:a["rowptr"][r + 1]]
        assert np.all(np.diff(c) > 0)


def test_kronecker_bit_rule():
    """``edges`` against the spec's rule written out one edge at a time."""
    scale, ef = 4, 2
    init = (0.57, 0.19, 0.19, 0.05)
    m = ef << scale
    rng = np.random.default_rng(3)
    draws = [rng.random(m) for _ in range(2 * scale)]
    pairs = iter(range(scale))
    got = kronecker.edges(scale, ef, init, lambda: torch.from_numpy(
        np.stack(draws[2 * next(pairs):][:2]))).numpy()
    a, b, c, _d = init
    want = np.zeros((2, m), np.int64)
    for e in range(m):
        for bit in range(scale):
            ii = draws[2 * bit][e] > a + b
            thresh = c / (1 - (a + b)) if ii else a / (a + b)
            jj = draws[2 * bit + 1][e] > thresh
            want[0, e] += int(ii) << bit
            want[1, e] += int(jj) << bit
    np.testing.assert_array_equal(got, want)


def test_kronecker_graph_scale_10():
    cfg = {"scale": 10, "edgefactor": 16,
           "initiator": [0.57, 0.19, 0.19, 0.05], "dtype": "float32"}
    a = kronecker.generate(cfg, 12345)
    n = 1 << 10
    rows = np.repeat(np.arange(n), np.diff(a["rowptr"]))
    cols = a["colidx"].astype(np.int64)
    assert a["m"] == a["n"] == n
    assert not np.any(rows == cols), "self-loop"
    key = rows * n + cols
    assert np.all(np.diff(key) > 0), "duplicate or unsorted"
    back = np.sort(cols * n + rows)
    np.testing.assert_array_equal(back, key)          # symmetric
    deg = np.diff(a["rowptr"])
    np.testing.assert_array_equal(a["vals"],
                                  (1.0 / deg[cols]).astype(np.float32))
    colsum = np.bincount(cols, weights=a["vals"].astype(np.float64),
                         minlength=n)
    np.testing.assert_allclose(colsum[deg > 0], 1.0, rtol=1e-6)
    assert a["vals"].dtype == np.float32
    # the same seed gives the same graph, another seed another one
    again = kronecker.generate(cfg, 12345)
    np.testing.assert_array_equal(again["colidx"], a["colidx"])
    other = kronecker.generate(cfg, 12346)
    assert other["colidx"].size != a["colidx"].size or \
        not np.array_equal(other["colidx"], a["colidx"])


def test_kronecker_takes_large_seeds():
    cfg = {"scale": 6, "edgefactor": 4,
           "initiator": [0.57, 0.19, 0.19, 0.05], "dtype": "float32"}
    a = kronecker.generate(cfg, 2 ** 31 + 12345)
    assert a["colidx"].size > 0
