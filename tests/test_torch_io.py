"""The port's Matrix Market I/O against the JAX package's
(tests/test_types_io.py::test_mmio_roundtrip and ::test_mmio_cache).

Held, bit for bit: ``read_mtx`` on the grid of symmetry × field (and a
dense array file), through the C++ parser and through the numpy text path,
each against the JAX package's ``read_mtx`` on the same path; the bytes
``write_mtx`` writes; ``load_matrix`` through its ``.npz`` cache (the
second load a hit, no parse); ``parse_mtx`` giving None where it cannot
parse.
"""

import itertools

import numpy as np
import pytest

from spmv_tpu.io import generate as j_gen
from spmv_tpu.io import mmio as j_mmio
from spmv_tpu_torch import native
from spmv_tpu_torch.io import mmio
from spmv_tpu_torch.types import CsrMatrix

GRID = [(s, f) for s, f in itertools.product(
    ("general", "symmetric", "skew-symmetric"),
    ("real", "integer", "pattern")) if (s, f) != ("skew-symmetric",
                                                  "pattern")]


def _write_coordinate(path, symmetry, field, m=12, n=12, nnz=30, seed=4):
    """test_mmio_roundtrip's file: random COO with duplicates, lower
    triangle for the symmetric kinds (strictly lower for skew)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    if symmetry != "general":
        rows, cols = np.maximum(rows, cols), np.minimum(rows, cols)
        if symmetry == "skew-symmetric":
            keep = rows != cols
            rows, cols = rows[keep], cols[keep]
    vals = {"real": rng.random(rows.size),
            "integer": rng.integers(-9, 9, rows.size).astype(np.float64),
            "pattern": np.ones(rows.size)}[field]
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} {symmetry}\n")
        f.write("% comment line\n")
        f.write(f"{m} {n} {rows.size}\n")
        for r, c, v in zip(rows, cols, vals):
            if field == "pattern":
                f.write(f"{r+1} {c+1}\n")
            elif field == "integer":
                f.write(f"{r+1} {c+1} {int(v)}\n")
            else:
                f.write(f"{r+1} {c+1} {v}\n")


def _same(a, b):
    assert (a.m, a.n) == (b.m, b.n)
    for k in ("rowptr", "colidx", "vals"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k


@pytest.mark.parametrize("symmetry,field", GRID)
@pytest.mark.parametrize("use_native", [True, False])
def test_read_mtx_equals_jax(tmp_path, symmetry, field, use_native):
    path = str(tmp_path / "t.mtx")
    _write_coordinate(path, symmetry, field)
    before = dict(mmio.reads)
    a = mmio.read_mtx(path, use_native=use_native)
    path_taken = "native" if use_native else "python"
    assert mmio.reads[path_taken] == before[path_taken] + 1
    _same(a, j_mmio.read_mtx(path, use_native=use_native))
    if symmetry != "skew-symmetric":
        # both paths give one matrix; on a skew-symmetric file the numpy
        # path's banner regex reads "skew" and keeps only the stored
        # triangle, in both packages (ROADMAP.md F3)
        _same(a, mmio.read_mtx(path, use_native=not use_native))
    for dtype in (np.float32, np.float64):
        _same(mmio.read_mtx(path, dtype=dtype, use_native=use_native),
              j_mmio.read_mtx(path, dtype=dtype, use_native=use_native))


@pytest.mark.parametrize("symmetry", ["general", "symmetric"])
def test_read_array_file_equals_jax(tmp_path, symmetry):
    # the dense array format: the C++ parser refuses it, so both packages
    # take the numpy path
    rng = np.random.default_rng(1)
    m = n = 5
    if symmetry == "general":
        flat = rng.random(m * n) * (rng.random(m * n) > 0.4)
    else:
        flat = rng.random(m * (m + 1) // 2)
    path = str(tmp_path / "d.mtx")
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix array real {symmetry}\n{m} {n}\n")
        f.write("".join(f"{float(v)!r}\n" for v in flat))
    assert native.parse_mtx(path) is None
    before = mmio.reads["python"]
    _same(mmio.read_mtx(path), j_mmio.read_mtx(path))
    assert mmio.reads["python"] == before + 1


def test_parse_mtx_none_for_missing_file(tmp_path):
    assert native.native_available()
    assert native.parse_mtx(str(tmp_path / "missing.mtx")) is None
    bad = tmp_path / "bad.mtx"
    bad.write_text("not a matrix market file\n")
    assert native.parse_mtx(str(bad)) is None
    with pytest.raises(ValueError):
        mmio.read_mtx(str(bad))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_write_mtx_bytes_equal_jax(tmp_path, dtype):
    a = j_gen.random_uniform(300, 200, 7, dtype=dtype, seed=8)
    t = CsrMatrix(a.m, a.n, a.rowptr, a.colidx, a.vals)
    j_mmio.write_mtx(str(tmp_path / "j.mtx"), a)
    mmio.write_mtx(str(tmp_path / "t.mtx"), t)
    assert (tmp_path / "j.mtx").read_bytes() == \
        (tmp_path / "t.mtx").read_bytes()
    # more rows than one formatting pass, and an empty matrix
    big = CsrMatrix(a.m, a.n, a.rowptr, a.colidx, a.vals)
    mmio._WRITE_ROWS, saved = 97, mmio._WRITE_ROWS
    try:
        mmio.write_mtx(str(tmp_path / "t2.mtx"), big)
    finally:
        mmio._WRITE_ROWS = saved
    assert (tmp_path / "t2.mtx").read_bytes() == \
        (tmp_path / "j.mtx").read_bytes()
    e = CsrMatrix(3, 4, np.zeros(4, np.int32), np.zeros(0, np.int32),
                  np.zeros(0, dtype))
    mmio.write_mtx(str(tmp_path / "e.mtx"), e)
    assert (tmp_path / "e.mtx").read_text() == \
        "%%MatrixMarket matrix coordinate real general\n3 4 0\n"
    # the round trip is exact: %.17g carries every f64 (and f32) value
    _same(mmio.read_mtx(str(tmp_path / "t.mtx"), dtype=dtype), t)


def test_load_matrix_cache(tmp_path):
    a = j_gen.random_uniform(20, 20, 3, seed=8)
    t = CsrMatrix(a.m, a.n, a.rowptr, a.colidx, a.vals)
    mtx = str(tmp_path / "m.mtx")
    mmio.write_mtx(mtx, t)
    cache = str(tmp_path / "cache")
    assert mmio.cache_path(mtx, cache) == j_mmio.cache_path(mtx, cache)
    reads = sum(mmio.reads.values())
    b1 = mmio.load_matrix(mtx, cache_dir=cache)
    assert sum(mmio.reads.values()) == reads + 1
    b2 = mmio.load_matrix(mtx, cache_dir=cache)       # a hit: no parse
    assert sum(mmio.reads.values()) == reads + 1
    np.testing.assert_array_equal(b1.to_dense(), a.to_dense())
    _same(b2, b1)
    # the JAX package reads the port's cache file, and the other way
    _same(j_mmio.load_matrix(mtx, cache_dir=cache), b1)
    _same(mmio.load_matrix(mtx, dtype=np.float32, cache_dir=cache),
          j_mmio.load_matrix(mtx, dtype=np.float32, cache_dir=cache))
