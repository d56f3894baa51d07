"""The end-to-end arithmetic of ``core``."""

import math
import statistics

import pytest

from spmvbench import core


def test_window_rate_and_tail():
    unit_s = [0.010] * 90 + [0.020] * 9 + [0.500]
    w = {"window_s": sum(unit_s), "units": len(unit_s), "unit_s": unit_s,
         "products": 51 * len(unit_s), "nnz": 1000, "predeal_s": 2.5,
         "setup_s": 12.0}
    # the rate is over all the work and all the time of the window
    assert core.E2E["solve_ms"](w) == pytest.approx(sum(unit_s) / 100 * 1e3)
    # the 95th percentile is over every solve: the 95th of 100 sorted
    assert core.E2E["solve_ms_p95"](w) == pytest.approx(20.0)
    assert core.E2E["spmv_gflops"](w) == pytest.approx(
        2 * 1000 * 5100 / sum(unit_s) / 1e9)
    assert core.E2E["setup_s"](w) == 12.0


@pytest.mark.parametrize("n", [1, 2, 19, 20, 21, 100, 1001])
def test_quantile_nearest_rank(n):
    vals = [float(i) for i in range(n, 0, -1)]
    q = core.quantile(vals, 0.95)
    k = sum(v <= q for v in vals)
    assert k >= 0.95 * n and (k - 1) < 0.95 * n


def test_least_bytes():
    # hpcg-104 in f64: 256.3 MB a product
    assert core.least_bytes(1_124_864, 1_124_864, 29_791_000, 8) == \
        (29_791_000 + 2 * 1_124_864) * 8 == 256_325_824
    assert core.least_bytes(10, 20, 100, 4) == 520


def test_roofline_share():
    # least time 0.8e-4 s over 1e-4 s a product
    rec = {"trace": {"recorded_products": 10, "spmv_device_s": 10 * 1e-4},
           "least_bytes": 0.8e-4 * 3.35e12, "peak_bytes_per_s": 3.35e12}
    assert core.roofline_share(rec) == pytest.approx(80.0)
    assert core.roofline_share({**rec, "peak_bytes_per_s": None}) is None
    assert core.roofline_share({**rec, "trace": None}) is None


def test_reservoir_is_seeded_and_uniform():
    a, b = core.Reservoir(3, 42), core.Reservoir(3, 42)
    for i in range(50):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items and len(a.items) == 3
    counts = [0] * 20
    for seed in range(2000):
        r = core.Reservoir(2, seed)
        for i in range(20):
            r.offer(i)
        for i in r.items:
            counts[i] += 1
    assert statistics.pstdev(counts) < 0.15 * statistics.mean(counts)


def test_applies():
    assert core.applies({"name": "x"}, "any")
    assert core.applies({"name": "x", "workloads": ["a"]}, "a")
    assert not core.applies({"name": "x", "workloads": ["a"]}, "b")


def test_metrics_are_never_zero_on_a_window():
    w = {"window_s": 1.0, "units": 3, "unit_s": [0.3, 0.3, 0.4],
         "products": 3, "nnz": 10, "predeal_s": 0.1, "setup_s": 1.0}
    for name, fn in core.E2E.items():
        v = fn(w)
        assert v > 0 and math.isfinite(v), name


@pytest.mark.parametrize("name", ["idle_share.solve", "idle_share.chain",
                                  "window_idle_share.solve",
                                  "window_idle_share.chain"])
def test_suffixed_metric_reads_its_stem(name):
    # one reader for every suffix.  idle_share: busy and window of the
    # same segment; window_idle_share: busy a unit of the segment over wall
    # a unit of the untraced window
    read = core.load(core.ROOT, "metrics", name).read
    rec = {"busy": {"busy_s": 0.06, "window_s": 0.08, "device_events": 9,
                    "units": 8},
           "window": {"window_s": 1.0, "units": 100}}
    assert read(rec) == pytest.approx(25.0)
    assert read({**rec, "busy": None}) is None
    with pytest.raises(FileNotFoundError):
        core.load(core.ROOT, "metrics", "no_such_metric.solve")


@pytest.mark.parametrize("name,want", [("predeal_s.traced", 2.5),
                                       ("pack_s", 2.25),
                                       ("transfer_s", 0.25)])
def test_predeal_readers(name, want):
    # the pre-deal, per layer: the traced run's, by its stem's reader
    read = core.load(core.ROOT, "metrics", name).read
    assert read({"predeal": {"total_s": 2.5, "transfer_s": 0.25}}) == \
        pytest.approx(want)


def test_chain_reads_late_and_drains():
    """The chain reads a block's scale ``read_lag`` blocks late; a bad
    block shows then, or in ``drain()`` at the window's close."""
    import torch
    from types import SimpleNamespace
    chain = core.load(core.ROOT, "loops", "chain")
    calls = []

    def spmv(h, x):
        calls.append(1)
        return x * (math.inf if len(calls) > 2 * 4 else 2.0)
    port = SimpleNamespace(spmv=spmv)
    h = SimpleNamespace(n=5)
    traffic = {"block": 4, "read_lag": 2}
    loop = chain.make(port, h, None, {"dtype": "float64"}, traffic, 3, "cpu")
    oks = [loop.unit(None)[1] for _ in range(3)]   # the third block is bad
    assert oks == [True, True, True] and len(loop.pending) == 2
    assert loop.drain() is False and not loop.pending
