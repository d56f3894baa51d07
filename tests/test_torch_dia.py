"""The port's DIA product (spmv_tpu_torch/ops/dia.py, the CUDA kernel's
plain version on the CPU) against the JAX plans it replaces: the TPU
kernels spmv_tpu.ops.pallas_dia (interpret mode; the f64 one through its
double-float planes) and the XLA plan spmv_tpu.ops.xla_csr.dia_spmv, on
the same packs.

Tolerance per row against (|A||x|)_i:
- f32: 1e-5 — the f32 sums are taken in another order;
- f64: 1e-12 against an exact numpy f64 sum of the same diagonals, and
  2e-6 against the TPU kernel in interpret mode, where XLA:CPU simplifies
  its error-free transforms to about f32 accuracy (the bound of
  tests/test_dia_df.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_tpu.formats.dia import pack_dia as jax_pack_dia
from spmv_tpu.ops.pallas_dia import build_dia_fn_from_parts, prepare_dia
from spmv_tpu.ops.xla_csr import dia_spmv
from spmv_tpu.types import CsrMatrix as JaxCsr
from spmv_tpu_torch.formats.dia import pack_dia
from spmv_tpu_torch.ops import dia as tdia
from spmv_tpu_torch.types import CsrMatrix


def _offsets_matrix(m, n, offsets, exact, seed):
    """Every in-range entry of the given diagonals."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for o in offsets:
        r = np.arange(max(0, -o), min(m, n - o))
        rows.append(r)
        cols.append(r + o)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = (rng.integers(1, 8, rows.size) / 8.0 if exact
            else rng.standard_normal(rows.size)).astype(np.float32)
    return CsrMatrix.from_coo(m, n, rows, cols, vals, sum_duplicates=False)


CASES = {
    "square_bf16": (4096, 4096, (-4, -1, 0, 1, 4), True),
    "wide_f32": (3000, 5200, (-300, -129, 0, 128, 700, 2500), False),
    "tall_bf16": (5200, 3000, (-2500, -700, -128, 0, 129, 300), True),
    "far_offsets_f32": (2500, 2500, (-2047, -1000, 1, 999, 2048), False),
}


def _pair(name):
    m, n, offs, exact = CASES[name]
    a = _offsets_matrix(m, n, offs, exact, seed=len(name))
    ja = JaxCsr(a.m, a.n, a.rowptr, a.colidx, a.vals)
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    return a, ja, x


def _port(a, x):
    p = tdia.prepare_dia(pack_dia(a), "cpu")
    y = tdia.dia_spmv(p, torch.from_numpy(x)).numpy()
    ab = CsrMatrix(a.m, a.n, a.rowptr, a.colidx, np.abs(a.vals))
    pa = tdia.prepare_dia(pack_dia(ab), "cpu")
    bound = tdia.dia_plain(pa, torch.from_numpy(np.abs(x))).numpy()
    return y, bound, p


@pytest.mark.parametrize("name", sorted(CASES))
def test_dia_matches_tpu_kernel(name):
    a, ja, x = _pair(name)
    y, bound, p = _port(a, x)
    assert p.data.dtype == (torch.bfloat16 if CASES[name][3]
                            else torch.float32)
    ref = np.asarray(build_dia_fn_from_parts(
        prepare_dia(jax_pack_dia(ja)), interpret=True)(jnp.asarray(x)))
    np.testing.assert_array_less(np.abs(y - ref), 1e-5 * bound + 1e-30)


@pytest.mark.parametrize("name", sorted(CASES))
def test_dia_matches_xla_plan(name):
    a, ja, x = _pair(name)
    y, bound, _ = _port(a, x)
    d = jax_pack_dia(ja)
    ref = np.asarray(dia_spmv(
        jnp.asarray(d.data).astype(jnp.float32), jnp.asarray(x),
        offsets=tuple(int(o) for o in d.offsets), m=a.m, n=a.n))
    np.testing.assert_array_less(np.abs(y - ref), 1e-5 * bound + 1e-30)


def test_dia_rejects_f64_and_other_devices():
    # f64 diagonals now have a kernel (K4); what the wrapper still rejects
    # is data of a type no kernel takes, and x on a device with no kernel,
    # for f32 and f64 plans alike
    a, _, x = _pair("square_bf16")
    a16 = CsrMatrix(a.m, a.n, a.rowptr, a.colidx, a.vals.astype(np.float16))
    with pytest.raises(ValueError):
        tdia.prepare_dia(pack_dia(a16, compress="none"), "cpu")
    for dt in (np.float32, np.float64):
        ad = CsrMatrix(a.m, a.n, a.rowptr, a.colidx, a.vals.astype(dt))
        p = tdia.prepare_dia(pack_dia(ad, compress="none"), "cpu")
        assert p.data.dtype == torch.from_numpy(np.zeros(1, dt)).dtype
        with pytest.raises(ValueError):
            tdia.dia_spmv(p, torch.empty(a.n, dtype=p.dtype,
                                         device="meta"))


@pytest.fixture
def x64():
    """The f64 tests run with jax_enable_x64 on and restore the flag."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", was)


@pytest.mark.parametrize("name", sorted(CASES))
def test_dia_f64_matches_tpu_kernel(name, x64):
    m, n, offs, _exact = CASES[name]
    a32 = _offsets_matrix(m, n, offs, False, seed=len(name))
    v = np.random.default_rng(3).standard_normal(a32.nnz) * np.exp(
        np.random.default_rng(4).uniform(-20, 20, a32.nnz))
    a = CsrMatrix(m, n, a32.rowptr, a32.colidx, v)
    x = np.random.default_rng(1).standard_normal(n)
    p = tdia.prepare_dia(pack_dia(a), "cpu")
    assert p.data.dtype == torch.float64
    y = tdia.dia_spmv(p, torch.from_numpy(x))
    assert y.dtype == torch.float64
    y = y.numpy()
    rows = np.repeat(np.arange(m), a.row_lengths)
    exact = np.zeros(m)
    np.add.at(exact, rows, a.vals * x[a.colidx])
    bound = np.zeros(m)
    np.add.at(bound, rows, np.abs(a.vals * x[a.colidx]))
    bound += 1e-300
    np.testing.assert_array_less(np.abs(y - exact), 1e-12 * bound)
    parts = prepare_dia(jax_pack_dia(JaxCsr(m, n, a.rowptr, a.colidx, v)))
    assert "data3_lo" in parts
    ref = np.asarray(build_dia_fn_from_parts(parts, interpret=True)(
        jnp.asarray(x)))
    np.testing.assert_array_less(np.abs(y - ref), 2e-6 * bound)
