"""The launch protocol and the stream kinds of ``spmv_tpu_torch/ops``
(``ops/__init__.py``) on the CPU: the one rule that gives a hybrid's part
the card's layout (K12 light, K13 heavy), its seam ``card_layout``; every
kernel wrapper's refusal of a device with no kernel, raised by the one
device switch; and every key of ``KINDS`` placed and bound by the handle
(``_place``, ``_stream_fn``) as its kind's product on its own stream.
The launches themselves run on the card (``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

from spmv_tpu_torch import handle as th, ops
from spmv_tpu_torch.bench import probes as pr
from spmv_tpu_torch.formats import csr_split as split_fmt, sell_cs as cs_fmt
from spmv_tpu_torch.formats.coo2 import pack_coo2
from spmv_tpu_torch.formats.dia import pack_dia
from spmv_tpu_torch.formats.sell8d import pack_sell8d, prepare_hybrid
from spmv_tpu_torch.formats.sell8w import pack_sell8w, plan_v2
from spmv_tpu_torch.io import generate as g
from spmv_tpu_torch.oracle import spmv_golden
from spmv_tpu_torch.types import CsrMatrix


# -- the rule (K12's light part over SELL-8D, K13's heavy part over SELL-8W)

@pytest.mark.parametrize("part,device,mode,ratio,want", [
    ("light", "cuda", "f32", 2.0, True),
    ("light", "cuda", "f32", 33.7, True),
    ("light", "cuda", "f32", 1.99, False),
    ("light", "cpu", "f32", 33.7, False),
    ("light", "cuda", "palette", 33.7, False),
    ("light", "cuda", "bf16", 33.7, False),
    ("light", "cuda", "df16", 33.7, False),
    ("light", "cuda", "df", 33.7, False),
    ("light", "cuda", "palette_df", 33.7, False),
    ("heavy", "cuda", "f32", 2.0, True),
    ("heavy", "cuda", "f32", 7.44 * 6 / 8, True),
    ("heavy", "cuda", "f32", 1.99, False),
    ("heavy", "cuda", "f32", 0.75, False),
    ("heavy", "cpu", "f32", 5.6, False),
    ("heavy", "cuda", "palette", 5.6, False),
    ("heavy", "cuda", "bf16", 5.6, False),
    ("heavy", "cuda", "df", 5.6, False),
])
def test_rule(part, device, mode, ratio, want):
    # ratio: the SELL stream's bytes over the card layout's; the rule is
    # the same for both parts (``part`` names the case's origin)
    tiles = 1000
    layout_bytes = int(round(ops.sell_bytes(tiles) / ratio))
    assert ops.use_card_layout(device, mode, tiles, layout_bytes) is want


def _powerlaw(m=10000, nnz=300_000, seed=2):
    """A power-law matrix with gaussian f32 values: a hybrid whose parts
    both take the card's layout on CUDA."""
    a = g.power_law(m, m, nnz, dtype=np.float32, seed=seed)
    return CsrMatrix(a.m, a.n, a.rowptr, a.colidx,
                     np.random.default_rng(seed).standard_normal(a.nnz)
                     .astype(np.float32))


@pytest.mark.parametrize("part", ["heavy", "light"])
@pytest.mark.parametrize("device", ["cuda", "cpu", None])
def test_card_layout_is_the_rule_on_the_part(part, device):
    # the seam packs the part in its kind's layout exactly where the rule
    # says so, and hands back None (the part keeps SELL) elsewhere
    a = _powerlaw()
    prep = prepare_hybrid(a)
    assert prep is not None
    rows, tiles, nw, key, fmt = (
        (prep.dense_sorted, prep.td, 1, "csr_split", split_fmt)
        if part == "heavy" else
        (prep.sparse, prep.ts, prep.nw, "sell_cs", cs_fmt))
    got = ops.card_layout(part, device, rows, tiles, nw, False)
    want = ops.use_card_layout(device, "f32", tiles,
                               fmt.layout_bytes(rows.row_lengths))
    assert (got is not None) == want
    if want:
        assert set(got) == {key, "value_mode"} and got["value_mode"] == "f32"
        assert got[key].nnz == rows.nnz
    # an f64 part never takes it
    assert ops.card_layout(part, device, rows, tiles, nw, True) is None


# -- the device switch: one refusal for every kernel wrapper ---------------

def _meta(*shape):
    return torch.empty(*shape, device="meta")


def _small():
    return g.clustered(2048, 2048, 8, spread=128, dtype=np.float32, seed=3)


def _ops_wrappers():
    a = _small()
    cs = ops.sell_cs.prepare_cs(cs_fmt.pack_sell_cs(a), "cpu")
    sp = ops.csr_split.prepare_split(split_fmt.pack_csr_split(a), "cpu")
    dia = ops.dia.prepare_dia(pack_dia(g.banded(512, 512, 3,
                                                dtype=np.float32)), "cpu")
    sell = ops.sell.prepare_sell(pack_sell8d(a)[0], "cpu", slot_mode=True)
    coo2 = ops.coo2.prepare_coo2(pack_coo2(a), "cpu")
    return {"dia_spmv": lambda: ops.dia.dia_spmv(dia, _meta(dia.n)),
            "sell_spmv": lambda: ops.sell.sell_spmv(sell, _meta(sell.n)),
            "coo2_pass1": lambda: ops.coo2.coo2_pass1(coo2, _meta(coo2.n)),
            "cs_spmv": lambda: ops.sell_cs.cs_spmv(cs, _meta(cs.n)),
            "split_spmv": lambda: ops.csr_split.split_spmv(sp, _meta(sp.n))}


def _probe_wrappers():
    body = pr.BodyStream(meta=_meta(2, 8, 128), vals=_meta(2, 8, 128),
                         palette=_meta(128), tinfo=_meta(2), ginfo=_meta(1),
                         x=_meta(1024), g=2, ngroups=1, value_mode="f32")
    planes = [_meta(4, 8, 128) for _ in range(3)]
    return {
        "tile_stream": lambda: pr.tile_stream(_meta(4, 8, 128), 1, True,
                                              _meta(8, 128)),
        "tile_body": lambda: pr.tile_body(body, _meta(8, 128)),
        "window_gather": lambda: pr.window_gather(False, *planes,
                                                  _meta(8, 1024), 2),
        "tiny": lambda: pr.tiny(_meta(8, 128)),
        "tiny_chain": lambda: pr.tiny_chain(_meta(8, 128), 3),
        "fma_err": lambda: pr.fma_err(_meta(8), _meta(8), _meta(8))}


WRAPPERS = ["dia_spmv", "sell_spmv", "coo2_pass1", "cs_spmv", "split_spmv",
            "tile_stream", "tile_body", "window_gather", "tiny",
            "tiny_chain", "fma_err"]


@pytest.mark.parametrize("op", WRAPPERS)
def test_a_meta_tensor_is_refused_by_the_one_switch(op):
    calls = {**_ops_wrappers(), **_probe_wrappers()}
    with pytest.raises(ValueError) as e:
        calls[op]()
    assert str(e.value) == f"{op}: no kernel for device meta"
    assert e.traceback[-1].name == "require_cpu"


# -- the kinds: every key placed and bound through KINDS ------------------

#: plan key → the host pack of a matrix (a key of KINDS missing here fails
#: the test below)
HOST_PACKS = {
    "sell8d": lambda a: pack_sell8d(a)[0],
    "sell8w_v2": lambda a: plan_v2(pack_sell8w(a)),
    "sell8w_v2w": lambda a: plan_v2(pack_sell8w(a)),
    "sell_cs": cs_fmt.pack_sell_cs,
    "csr_split": lambda a: split_fmt.pack_csr_split(a, piece=16),
    "dia": lambda a: pack_dia(a, compress="none"),
    "coo2": pack_coo2}


@pytest.mark.parametrize("key", sorted(ops.KINDS))
def test_place_and_bind_read_the_kind(key):
    a = (g.banded(2048, 2048, 4, dtype=np.float32) if key == "dia"
         else _small())
    kind = ops.KINDS[key]
    placed = th._place({key: HOST_PACKS[key](a), "value_mode": "f32"}, "cpu")
    st = placed[key]
    assert type(st) is type(kind.prepare(HOST_PACKS[key](a), "cpu"))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(a.n)
                         .astype(np.float32))
    fn = th._stream_fn(placed, a.m)
    y = fn(x)
    want = kind.product(st, x)
    assert torch.equal(y, want[:st.m] if kind.cut else want)
    assert y.shape == (a.m,)
    assert torch.equal(th._make_bound(th.Method.AUTO, placed, a.m)(x), y)
    ref = spmv_golden(a.astype(np.float64), x.numpy().astype(np.float64))
    absref = spmv_golden(CsrMatrix(a.m, a.n, a.rowptr, a.colidx,
                                   np.abs(a.vals).astype(np.float64)),
                         np.abs(x.numpy()).astype(np.float64))
    assert np.all(np.abs(y.numpy() - ref) <= 1e-5 * absref + 1e-30)
