"""The port's SELL tile-stream product (spmv_tpu_torch/ops/sell.py, the CUDA
kernel's plain version on the CPU) against the TPU kernel it replaces,
spmv_tpu.ops.pallas_sell._run_v2 run in interpret mode, on the same
streams: random streams (every decode rule, including the cell reads) and
streams from the JAX package's packers.

Tolerance per row: |Δy| ≤ 1e-5·(|A||x|)_i — the f32 sums are taken in
another order.
"""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from spmv_tpu.formats.sell8d import pack_sell8d
from spmv_tpu.formats.sell8w import pack_sell8w, plan_v2
from spmv_tpu.io import generate
from spmv_tpu.ops.pallas_sell import _run_v2
from spmv_tpu_torch.ops import sell as tsell


@dataclasses.dataclass
class _Stream:
    """A packed stream's fields, as the packers name them."""
    m: int
    n: int
    nslices: int
    g: int
    nsteps: int
    value_mode: str
    tinfo: np.ndarray
    ginfo: np.ndarray
    meta: np.ndarray
    vals: object
    palette: object
    nw: int = 1
    cell_w: bool = False


def _reference(pk, x, slot_mode):
    pal = np.tile((pk.palette if pk.palette is not None
                   else np.zeros(128, np.float32))[None, :], (8, 1))
    out = _run_v2(jnp.asarray(pk.tinfo), jnp.asarray(pk.ginfo),
                  jnp.asarray(x), jnp.asarray(pk.meta),
                  None if pk.vals is None else jnp.asarray(pk.vals),
                  jnp.asarray(pal), g=pk.g, value_mode=pk.value_mode,
                  nsteps=pk.nsteps, nslices=pk.nslices, n=pk.n,
                  interpret=True, slot_mode=slot_mode,
                  nw=getattr(pk, "nw", 1),
                  cell_w=bool(getattr(pk, "cell_w", False)))
    return np.asarray(out, dtype=np.float64).reshape(-1)


def _check(pk, slot_mode, x=None):
    if x is None:
        x = np.random.default_rng(0).standard_normal(pk.n).astype(
            np.float32)
    st = tsell.prepare_sell(pk, "cpu", slot_mode)
    y = tsell.sell_spmv(st, torch.from_numpy(x)).numpy()
    abs_st = dataclasses.replace(
        st, palette=st.palette.abs(),
        vals=None if st.vals is None else st.vals.abs())
    bound = tsell.sell_plain(abs_st, torch.from_numpy(np.abs(x))).numpy()
    ref = _reference(pk, x, slot_mode)
    assert y.shape == ref.shape
    np.testing.assert_array_less(np.abs(y - ref), 1e-5 * bound + 1e-30)
    return y


def _random_stream(slot_mode, nw, cell_w, value_mode, g, seed):
    """Random meta (every bit pattern), tinfo and monotone ginfo that
    visits every output block: valid kernel input, whatever a packer
    would emit."""
    rng = np.random.default_rng(seed)
    nblocks, nsteps = 3, 7
    nslices = nblocks if slot_mode else 8 * nblocks
    n = 3 * 1024 * nw - 300                       # last bundle ragged
    ntiles = nsteps * g
    blocks = np.sort(np.concatenate([np.arange(nblocks),
                                     rng.integers(0, nblocks,
                                                  nsteps - nblocks)]))
    first = np.ones(nsteps, np.int64)
    first[1:] = blocks[1:] != blocks[:-1]
    nb = -(-n // (1024 * nw))
    tinfo = (rng.integers(0, nb, ntiles) << 3
             | rng.integers(0, 8, ntiles)).astype(np.int32)
    meta = rng.integers(0, 1 << 16, (ntiles, 8, 128)).astype(
        np.uint16).view(np.int16)
    vals = pal = None
    v = rng.standard_normal((ntiles, 8, 128)).astype(np.float32)
    if value_mode == "palette":
        pal = np.zeros(128, np.float32)
        pal[1:64] = rng.standard_normal(63)
    elif value_mode == "bf16":
        vals = v.astype(ml_dtypes.bfloat16)
    else:
        vals = v
    return _Stream(m=nblocks * 1024, n=n, nslices=nslices, g=g,
                   nsteps=nsteps, value_mode=value_mode, tinfo=tinfo,
                   ginfo=(blocks << 1 | first).astype(np.int32), meta=meta,
                   vals=vals, palette=pal, nw=nw, cell_w=cell_w)


@pytest.mark.parametrize("slot_mode,nw,cell_w,value_mode,g", [
    (False, 1, False, "f32", 2),
    (False, 1, False, "bf16", 3),
    (False, 1, False, "palette", 2),
    (True, 1, False, "f32", 2),
    (True, 2, False, "bf16", 2),
    (True, 2, True, "palette", 2),
    (True, 4, False, "palette", 2),
    (True, 4, True, "bf16", 3),
    (True, 8, False, "f32", 2),
    (True, 8, True, "palette", 2),
])
def test_random_stream_matches_tpu_kernel(slot_mode, nw, cell_w,
                                          value_mode, g):
    pk = _random_stream(slot_mode, nw, cell_w, value_mode, g, seed=nw + g)
    _check(pk, slot_mode)


def test_s_and_window_are_read_at_the_cell():
    # one slot-mode tile, nw=2, cell_w: slot (0, 3) names residue r=5 and
    # carries s=1, w=0 itself; the cell (0, 5) says s=3, w=1 — the cell wins
    meta = np.zeros((1, 8, 128), np.uint16)
    meta[0, 0, 3] = (1 << 7) | 5
    meta[0, 0, 5] = (1 << 10) | (3 << 7) | 5
    x = np.zeros(4096, np.float32)
    x[1024 + 3 * 128 + 5] = 7.0
    pk = _Stream(m=1024, n=4096, nslices=1, g=1, nsteps=1,
                 value_mode="f32", tinfo=np.zeros(1, np.int32),
                 ginfo=np.ones(1, np.int32), meta=meta.view(np.int16),
                 vals=np.full((1, 8, 128), 2.0, np.float32), palette=None,
                 nw=2, cell_w=True)
    y = _check(pk, True, x)
    assert y[3] == 14.0
    # without cell_w the window select is the slot's own (w=0 here)
    pk.cell_w = False
    x0 = tsell.sell_spmv(tsell.prepare_sell(pk, "cpu", True),
                         torch.from_numpy(x)).numpy()
    assert x0[3] == 0.0


@pytest.mark.parametrize("values", ["palette", "bf16", "f32"])
def test_row_mode_on_packed_streams(values):
    base = generate.with_empty_rows(
        generate.clustered(3000, 5000, 12, spread=300, dtype=np.float32,
                           seed=3), 0.3, seed=4)
    rng = np.random.default_rng(5)
    if values == "bf16":     # > 64 distinct values, all bf16-exact
        v = rng.integers(1, 256, base.nnz).astype(np.float32) / 64
    elif values == "f32":
        v = rng.standard_normal(base.nnz).astype(np.float32)
    else:
        v = base.vals
    a = type(base)(base.m, base.n, base.rowptr, base.colidx, v)
    v2 = plan_v2(pack_sell8w(a), g=4)        # g padding per group
    assert v2.value_mode == values
    _check(v2, slot_mode=False)


@pytest.mark.parametrize("nw,cell_w", [(1, False), (2, False), (2, True),
                                       (4, False), (4, True), (8, False),
                                       (8, True)])
def test_slot_mode_on_packed_streams(nw, cell_w):
    a = generate.random_uniform(3000, 30000, 6, dtype=np.float32, seed=nw)
    if nw >= 4:              # palette shrinks to 64 >> log2(nw) entries
        v = np.random.default_rng(nw).standard_normal(a.nnz)
        a = type(a)(a.m, a.n, a.rowptr, a.colidx, v.astype(np.float32))
    pk, _rest = pack_sell8d(a, g=8, max_pad_ratio=256.0, max_spill=0.05,
                            nw=nw, cell_w=cell_w)
    assert pk.nw == nw and pk.cell_w == cell_w
    _check(pk, slot_mode=True)


def test_chunk_tables_cut_inside_blocks():
    step_block = np.array([0, 0, 0, 0, 0, 1, 2, 2, 2])
    csp, bcp = tsell.chunk_tables(step_block, 4, g=32)   # 2 steps a chunk
    assert csp.tolist() == [0, 2, 4, 5, 6, 8, 9]
    assert bcp.tolist() == [0, 3, 4, 6, 6]      # block 3: no chunk → 0
    with pytest.raises(ValueError):
        tsell.chunk_tables(np.array([0, 1, 0]), 2, g=16)


def test_wrapper_takes_no_other_device():
    pk = _random_stream(False, 1, False, "f32", 2, seed=0)
    st = tsell.prepare_sell(pk, "cpu", False)
    with pytest.raises(ValueError):
        tsell.sell_spmv(st, torch.empty(pk.n, device="meta"))
