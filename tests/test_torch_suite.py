"""The port's CSV suite against the JAX package's (tests/test_suite.py,
test_rect_bench.py::test_suite_benches_rect_matrix), on device="cpu", and
its bandwidth model (``utils/perfmodel.py``) against the JAX copy.

Held: the reference's CSV header, character for character; rows of ten
columns (twelve with ``split_predeal``) with rmse below 1e-4 against the
golden product, on uniform10k and on rectangular matrices; the builtin
matrices' arrays equal the JAX generators'; a planning refusal, or a plan
out of card memory at any stage, reported as a comment while the sweep
goes on, and an error of the card propagating; the CLI, in f32 and in
bf16.
"""

import io as _io
import itertools

import numpy as np
import pytest

from spmv_tpu.bench import suite as j_suite
from spmv_tpu.utils import perfmodel as j_perf
import spmv_tpu_torch as st
from spmv_tpu_torch.bench import suite
from spmv_tpu_torch.io import generate
from spmv_tpu_torch.utils import perfmodel
from test_torch_tune import OOM_POINTS, oom_in


def test_csv_header_and_builtins_equal_jax():
    assert suite.CSV_HEADER == j_suite.CSV_HEADER
    assert list(suite.BUILTIN_MATRICES) == list(j_suite.BUILTIN_MATRICES)
    assert suite._DEFAULT_METHODS == [st.Method(int(m)) for m in
                                      j_suite._DEFAULT_METHODS]


@pytest.mark.parametrize("name", ["uniform10k", "banded100k", "blocky"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_load_any_builtin_equals_jax(name, dtype):
    n, a = suite.load_any(f"builtin:{name}", dtype=dtype)
    jn, j = j_suite.load_any(f"builtin:{name}", dtype=dtype)
    assert n == jn == name
    assert (a.m, a.n) == (j.m, j.n)
    for k in ("rowptr", "colidx", "vals"):
        x, y = getattr(a, k), getattr(j, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k


def test_load_any_mtx_path(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)        # load_matrix caches in ./mtx_cache
    a = generate.random_uniform(30, 40, 3, seed=2)
    path = str(tmp_path / "m.mtx")
    st.io.mmio.write_mtx(path, a)
    name, b = suite.load_any(path, dtype=np.float32)
    assert name == path and b.vals.dtype == np.float32
    np.testing.assert_array_equal(b.to_dense(), a.astype(np.float32)
                                  .to_dense())


def _check_rows(rows, a, name, ncols=10):
    for row in rows:
        f = row.split(",")
        assert len(f) == ncols
        assert f[0] == name and int(f[3]) == 1 and int(f[4]) == a.nnz
        assert float(f[5]) < 1e-4                  # rmse vs golden
        assert float(f[7]) > 0 and float(f[8]) > 0 and float(f[9]) > 0


def test_bench_matrix_csv_schema():
    _, a = suite.load_any("builtin:uniform10k")
    out = _io.StringIO()
    methods = [st.Method.AUTO, st.Method.SERIAL, st.Method.DIA]
    rows = suite.bench_matrix("uniform10k", a, methods, iters=1, repeats=1,
                              external=True, out=out, device="cpu")
    # AUTO resolves to CSR5 here; DIA refuses a scattered matrix: a
    # comment line, and the sweep goes on
    assert "# uniform10k,Method_Dia: handle failed: DIA unprofitable" \
        in out.getvalue()
    assert [r.split(",")[1] for r in rows] == [
        "Method_Csr5Spmv", "Method_Serial", "ScipyCsr", "TorchCsr"]
    _check_rows(rows, a, "uniform10k")
    assert [r for r in out.getvalue().splitlines()
            if not r.startswith("#")] == rows


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bench_matrix_rect_split_predeal(dtype):
    a = generate.banded(256, 400, 3, dtype=dtype, seed=1)
    rows = suite.bench_matrix("rect", a, [st.Method.SERIAL,
                                          st.Method.BALANCED],
                              iters=3, repeats=1, external=True,
                              split_predeal=True, out=_io.StringIO(),
                              device="cpu")
    assert len(rows) == 4
    _check_rows(rows, a, "rect", ncols=12)
    for row in rows[:2]:
        pack_ms, transfer_ms = map(float, row.split(",")[10:])
        assert pack_ms >= 0 and transfer_ms >= 0
    assert all(r.endswith(",,") for r in rows[2:])
    if dtype == np.float64:
        assert all(float(r.split(",")[5]) < 1e-8 for r in rows)


def test_bench_matrix_cuda_error_propagates(monkeypatch):
    # an error of the card is sticky: the sweep must stop, not report it
    # as one method failing
    import spmv_tpu_torch.handle as th
    real = th.create_handle

    def broken(*a, **k):
        h = real(*a, **k)

        def bound(_x):
            raise RuntimeError("dia launch failed: CUDA error 719 "
                               "(unspecified launch failure)")
        h._bound = bound
        return h

    monkeypatch.setattr(th, "create_handle", broken)
    a = generate.banded(100, 100, 2, dtype=np.float32, seed=1)
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        suite.bench_matrix("b", a, [st.Method.SERIAL, st.Method.DIA],
                           iters=1, repeats=1, out=_io.StringIO(),
                           device="cpu")


@pytest.mark.parametrize("where", OOM_POINTS)
def test_bench_matrix_out_of_memory_reported(monkeypatch, where):
    # a plan the card cannot hold prints the comment row and the sweep
    # goes on ("report, keep sweeping")
    emptied = oom_in(monkeypatch, st.Method.SERIAL, where)
    a = generate.banded(100, 100, 2, dtype=np.float32, seed=1)
    out = _io.StringIO()
    rows = suite.bench_matrix("b", a, [st.Method.SERIAL, st.Method.DIA],
                              iters=1, repeats=1, external=True, out=out,
                              device="cpu")
    stage = ("handle failed" if where in ("plan", "place")
             else "exec/timing failed")
    assert (f"# b,Method_Serial: {stage}: CUDA out of memory"
            in out.getvalue())
    assert [r.split(",")[1] for r in rows] == ["Method_Dia", "ScipyCsr",
                                               "TorchCsr"]
    _check_rows(rows, a, "b")
    assert emptied


def test_cli(tmp_path, capsys):
    out = tmp_path / "rows.csv"
    assert suite.main(["builtin:blocky", "--methods", "AUTO,SERIAL",
                       "--iters", "1", "--repeats", "1", "--device", "cpu",
                       "--out", str(out)]) == 0
    lines = out.read_text().splitlines()
    assert lines[0] == suite.CSV_HEADER and len(lines) == 3
    assert capsys.readouterr().out.splitlines() == lines
    # bf16: the same rows' fields, the matrix rounded to bf16
    out16 = tmp_path / "rows16.csv"
    assert suite.main(["builtin:blocky", "--methods", "AUTO,SERIAL",
                       "--dtype", "bfloat16", "--iters", "1", "--repeats",
                       "1", "--device", "cpu", "--out", str(out16)]) == 0
    lines16 = out16.read_text().splitlines()
    assert lines16[0] == suite.CSV_HEADER and len(lines16) == 3
    assert [r.split(",")[1] for r in lines16[1:]] == [
        r.split(",")[1] for r in lines[1:]]
    _check_rows(lines16[1:], suite.load_any("builtin:blocky")[1],
                "blocky")


SHAPES = [(1000, 1000, 5000), (256, 400, 1791), (4_000_000, 4_000_000,
                                                  35_999_980), (1, 7, 0)]


@pytest.mark.parametrize("m,n,nnz", SHAPES)
def test_perfmodel_equals_jax(m, n, nnz):
    for fmt, val_bytes, idx_bytes, pad in itertools.product(
            ("csr", "sell8w", "dia"), (2, 4, 8), (4, 8), (1.0, 1.37, 9.0)):
        kw = dict(val_bytes=val_bytes, idx_bytes=idx_bytes, fmt=fmt,
                  pad_ratio=pad)
        assert perfmodel.bytes_moved(m, n, nnz, **kw) == \
            j_perf.bytes_moved(m, n, nnz, **kw)
        if nnz:
            assert perfmodel.roofline_gflops(m, n, nnz, 3350.0, **kw) == \
                j_perf.roofline_gflops(m, n, nnz, 3350.0, **kw)
    with pytest.raises(ValueError):
        perfmodel.bytes_moved(m, n, nnz, fmt="coo")
    assert st.utils.roofline_gflops is perfmodel.roofline_gflops


def test_profiling_utils(tmp_path):
    # trace writes a Chrome trace; dev_asarray passes None through and
    # places arrays
    import json

    import torch

    from spmv_tpu_torch.utils import dev_asarray, predeal_profile, trace
    with trace(str(tmp_path / "t")) as prof:
        torch.ones(64).sum()
    assert prof is not None
    events = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert events["traceEvents"]
    assert dev_asarray(None, "cpu") is None
    with predeal_profile() as laps:
        t = dev_asarray(np.arange(5, dtype=np.int32), "cpu")
    assert t.tolist() == list(range(5)) and laps["bytes"] == 20
