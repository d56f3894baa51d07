"""The port's tune() and timing against the JAX package's
(tests/test_tune.py, test_rect_bench.py::test_tune_rect and
::test_chain_timing_rect_protocol), on device="cpu".

Held: the same default candidates; the winner cached and built without a
sweep on the second call; ``budget_s=0.0`` measuring one candidate; a
record of another device, or one at the JAX package's path, being a miss;
an error of the card propagating out of the sweep; ``time_spmv_chain``'s
dict with the JAX keys and positive times.  A tuned handle's y is held to
the golden product at 1e-4, test_tune.py's bound.
"""

import inspect
import json

import numpy as np
import pytest
import torch

from spmv_tpu.inspector import tune as j_tune
from spmv_tpu.io import generate as j_gen
import spmv_tpu_torch as st
from spmv_tpu_torch.bench import timing
from spmv_tpu_torch.inspector import _tune_cache_path, tune
from spmv_tpu_torch.io import generate


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """A private tune cache for the port, and another for the JAX
    package."""
    monkeypatch.setenv("SPMV_TPU_TORCH_CACHE", str(tmp_path / "torch"))
    monkeypatch.setenv("SPMV_TPU_CACHE", str(tmp_path / "jax"))
    return tmp_path


def _no_sweep(monkeypatch):
    def boom(*_a, **_k):
        raise AssertionError("cache miss: tune swept again")
    monkeypatch.setattr(timing, "time_spmv_chain", boom)


def _golden_close(h, a, x):
    y = st.spmv(h, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, st.spmv_golden(a, x), rtol=1e-4,
                               atol=1e-4)


def test_tune_default_candidates_equal_jax():
    names = ("DIA", "BCSR", "SELL_C_SIGMA", "CSR5", "BALANCED2", "BALANCED",
             "SERIAL")

    def defaults(fn):
        src = inspect.getsource(fn)
        body = src[src.index("if methods is None:"):]
        body = body[:body.index("]") + 1]
        words = body.replace(",", " ").replace("[", " ").replace("]", " ")
        return [w for w in words.split() if w.startswith("Method.")]

    assert defaults(tune) == defaults(j_tune)
    assert defaults(tune) == [f"Method.{m}" for m in names]


def test_tune_picks_winner_and_caches(cache, monkeypatch):
    a = generate.random_uniform(2000, 2000, 8, dtype=np.float32, seed=1)
    x = np.random.default_rng(0).standard_normal(a.n).astype(np.float32)
    h, results = tune(a, iters=2, repeats=1, x=x, mtx_token="t1",
                      device="cpu")
    assert set(results) == {st.METHOD_NAMES[m] for m in (
        st.Method.DIA, st.Method.BCSR, st.Method.SELL_C_SIGMA,
        st.Method.CSR5, st.Method.BALANCED2, st.Method.BALANCED,
        st.Method.SERIAL)}
    # DIA and BCSR refuse this scattered matrix; the others are timed
    assert results["Method_Dia"] == results["Method_Bcsr"] == float("inf")
    finite = {k: v for k, v in results.items() if np.isfinite(v)}
    assert len(finite) == 5 and all(v > 0 for v in finite.values())
    assert results[st.METHOD_NAMES[h.requested_method]] == \
        min(results.values())
    assert h.device == torch.device("cpu")
    _golden_close(h, a, x)
    with open(_tune_cache_path("t1")) as f:
        rec = json.load(f)
    assert rec["device"] == "cpu" and rec["m"] == a.m
    assert rec["nnz"] == a.nnz and rec["dtype"] == "float32"
    # second call: a cache hit builds the winner and never times
    _no_sweep(monkeypatch)
    h2, results2 = tune(a, iters=2, repeats=1, x=x, mtx_token="t1",
                        device="cpu")
    assert h2.method == h.method
    assert results2 == {h.method_name: rec["seconds"]}
    _golden_close(h2, a, x)


@pytest.mark.parametrize("stale", ["device", "nnz", "jax_path"])
def test_tune_cache_miss(cache, monkeypatch, stale):
    # a record for another device or matrix, or the JAX package's record
    # of the same token, must not apply: the port sweeps
    a = generate.random_uniform(600, 600, 5, dtype=np.float32, seed=2)
    rec = {"method": int(st.Method.DIA), "seconds": 1e-9, "m": a.m,
           "nnz": a.nnz, "dtype": "float32", "device": "cpu",
           "sweep_seconds": 0.0}
    if stale == "jax_path":
        (cache / "jax").mkdir()
        path = cache / "jax" / "tune_t2.json"
        del rec["device"]
    else:
        path = _tune_cache_path("t2")
        rec[stale] = {"device": "NVIDIA H100 80GB HBM3",
                      "nnz": a.nnz + 1}[stale]
    with open(path, "w") as f:
        json.dump(rec, f)
    calls = []
    real = timing.time_spmv_chain
    monkeypatch.setattr(timing, "time_spmv_chain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    h, results = tune(a, iters=2, repeats=1, mtx_token="t2", device="cpu")
    assert calls and len(results) == 7
    assert h.method != st.Method.DIA


def test_tune_budget_skips_tail(cache):
    a = generate.random_uniform(512, 512, 6, dtype=np.float32, seed=3)
    x = np.random.default_rng(0).standard_normal(a.n).astype(np.float32)
    h, results = tune(a, iters=2, repeats=1, x=x, budget_s=0.0,
                      device="cpu")
    finite = [v for v in results.values() if v != float("inf")]
    assert len(finite) == 1
    assert any(v == float("inf") for v in results.values())
    _golden_close(h, a, x)


def test_tune_rect():
    a = generate.random_uniform(300, 180, 5, dtype=np.float64, seed=2)
    h, results = tune(a, methods=[st.Method.SERIAL, st.Method.BALANCED_YID],
                      iters=3, repeats=1, device="cpu")
    assert h.m == 300 and h.n == 180
    assert all(np.isfinite(v) and v > 0 for v in results.values())


def test_tune_cuda_error_propagates(cache, monkeypatch):
    # an error of the card is sticky: the sweep must not report a winner
    # past it
    import spmv_tpu_torch.handle as th
    real = th.create_handle

    def broken(*a, **k):
        h = real(*a, **k)
        if h.method == st.Method.SERIAL:
            def bound(_x):
                raise RuntimeError("sell launch failed: CUDA error 700 "
                                   "(an illegal memory access was "
                                   "encountered)")
            h._bound = bound
        return h

    monkeypatch.setattr(th, "create_handle", broken)
    a = generate.random_uniform(400, 400, 5, dtype=np.float32, seed=4)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tune(a, iters=2, repeats=1, device="cpu")
    assert timing.is_cuda_error(RuntimeError("CUDA error: out of memory"))
    assert not timing.is_cuda_error(ValueError("DIA unprofitable"))


def test_chain_timing_rect_protocol():
    a = generate.banded(200, 300, 2, dtype=np.float64, seed=3)
    h = st.create_handle(a, method=st.Method.SERIAL, device="cpu")
    x = torch.from_numpy(generate.make_x(a.n, np.float64, kind="normal",
                                         seed=4))
    r = timing.time_spmv_chain(h._bound, x, iters=3, k=4, repeats=1)
    assert set(r) == {"inclusive", "marginal", "bubble", "t_1", "t_k", "k"}
    assert r["inclusive"] > 0 and r["marginal"] > 0 and r["k"] == 4
    assert r["t_k"] > 0 and r["t_1"] > 0 and r["bubble"] >= 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_renorm_is_an_exact_power_of_two(dtype):
    # the chain's renormalisation divides by a power of two, so it is
    # exact; y = 0 stays 0 (the 1e-30 floor), as in the JAX package
    y = torch.from_numpy(np.array([3.0, -5.0, 0.25, 1e-3], dtype))
    s = timing._pow2_floor(y)
    assert float(s) == 4.0
    assert torch.equal(timing._renorm(y) * 4, y)
    z = timing._renorm(torch.zeros(3, dtype=y.dtype))
    assert torch.equal(z, torch.zeros(3, dtype=y.dtype))
    big = torch.from_numpy(np.array([2.0 ** 40], dtype))
    assert float(timing._pow2_floor(big)) == 2.0 ** 40


def test_time_op_samples_chain_from_x0():
    # each sample chains ``iters`` calls from x0, after one warm call
    seen = []

    def step(x):
        seen.append(float(x[0]))
        return x + 1
    x0 = torch.zeros(4)
    samples = timing.time_op_samples(step, x0, iters=3, repeats=2)
    assert len(samples) == 2 and all(s > 0 for s in samples)
    assert seen == [0.0, 0.0, 1.0, 2.0, 0.0, 1.0, 2.0]
    assert timing.time_op(step, x0, iters=2, repeats=2) > 0


def test_jax_tune_writes_where_the_port_never_reads(cache):
    # the JAX package's tuner keeps its own directory: a token tuned there
    # never reaches the port's path
    from spmv_tpu.types import Method as JMethod
    a = j_gen.random_uniform(300, 300, 4, dtype=np.float32, seed=5)
    j_tune(a, methods=[JMethod.SERIAL], iters=1, repeats=1, mtx_token="t3")
    assert (cache / "jax" / "tune_t3.json").exists()
    assert not (cache / "torch" / "tune_t3.json").exists()
