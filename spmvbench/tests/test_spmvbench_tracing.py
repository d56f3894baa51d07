"""The readers of the port's spans: each returns its figure from a
hand-made record and span table, and None where the table (or the
record) lacks what it reads, as in an untraced run or against a port
without the spans."""

import pytest

from spmvbench import core, spans

TABLE = {"spmv.product": {"count": 400, "inclusive_s": 0.012,
                          "self_s": 0.002},
         "spmv.kernel.dia_f64": {"count": 400, "inclusive_s": 0.008,
                                 "self_s": 0.008},
         "solver.solve": {"count": 8, "inclusive_s": 0.096, "self_s": 0.05},
         "solver.read": {"count": 80, "inclusive_s": 0.04,
                         "self_s": 0.04}}


def reader(name):
    return core.load(core.ROOT, "metrics", name).read


@pytest.mark.parametrize("name", ["dispatch_us.solve", "dispatch_us.chain"])
def test_dispatch_us(name):
    # 12 ms over 400 products: 30 us a product
    read = reader(name)
    assert read({}, TABLE) == pytest.approx(30.0)
    assert read({}, {k: v for k, v in TABLE.items()
                     if k != "spmv.product"}) is None
    assert read({}, {}) is None


def test_read_wait_ms():
    # 40 ms of reads over 8 solves: 5 ms a solve
    read = reader("read_wait_ms.cg")
    assert read({}, TABLE) == pytest.approx(5.0)
    for gone in ("solver.read", "solver.solve"):
        assert read({}, {k: v for k, v in TABLE.items() if k != gone}) \
            is None
    assert read({}, {}) is None


@pytest.mark.parametrize("name", ["inspect_s", "prepare_s", "build_s",
                                  "place_s"])
def test_predeal_stage_readers(name):
    read = reader(name)
    laps = {"total_s": 2.5, "transfer_s": 0.04, "bytes": 1,
            "inspect_s": 0.3, "prepare_s": 0.0, "build_s": 1.9,
            "place_s": 0.25}
    assert read({"predeal": laps}) == laps[name]
    # an untraced run's record, or a port without the stage spans
    assert read({"predeal": {"total_s": 2.5}}) is None
    assert read({"predeal": {"total_s": 2.5, "transfer_s": 0.04,
                             "bytes": 1}}) is None


def test_span_readers_take_the_ports_table():
    # without a table the readers take the port's own, after a run: a
    # product under a pre-deal record (spans live) reaches it
    import torch

    import spmv_tpu_torch as port
    from spmv_tpu_torch.utils import profiling

    a = port.CsrMatrix(2, 2, [0, 1, 2], [0, 1], [1.0, 2.0])
    h = port.create_handle(a, port.Method.SERIAL, device="cpu")
    profiling.reset_spans()
    assert reader("dispatch_us.solve")({}) is None
    with profiling.predeal_profile():
        port.spmv(h, torch.ones(2))
    got = spans.table()
    assert got["spmv.product"]["count"] == 1
    assert reader("dispatch_us.solve")({}) == pytest.approx(
        got["spmv.product"]["inclusive_s"] * 1e6)
    profiling.reset_spans()
