"""The port's SELL tile-stream product (spmv_tpu_torch/ops/sell.py, the CUDA
kernel's plain version on the CPU) against the TPU kernels it replaces,
spmv_tpu.ops.pallas_sell._run_v2 (f32) and _run_v2_df (f64), past 2M
columns their windowed forms _run_v2w (K5), _run_v2w_slot (K6) and
_run_v2w_df (K7), and the v1 kernels _run (K9, K11 binary) and _run_df_v1
(K10), run in interpret mode, on the same streams: random
streams (every decode rule, including the cell reads) and streams from the
JAX package's packers.

Tolerance per row against (|A||x|)_i:
- f32: 1e-5 against the TPU kernel — the f32 sums are taken in another
  order;
- f64: 1e-12 against an exact numpy f64 decode of the same pack (both sum
  the same f64 values in another order), and 2e-6 against the TPU kernel
  in interpret mode — XLA:CPU simplifies its error-free transforms to
  about f32 accuracy (the bound of tests/test_sell8w_f64.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from spmv_tpu.formats.sell8d import pack_sell8d
from spmv_tpu.formats.sell8w import pack_sell8w, plan_v2
from spmv_tpu.io import generate
from spmv_tpu.ops.pallas_sell import (_run, _run_df_v1, _run_v2, _run_v2_df,
                                      _run_v2w, _run_v2w_df, _run_v2w_slot,
                                      pack_gpk)
from spmv_tpu.types import CsrMatrix as JaxCsr
from spmv_tpu_torch.ops import sell as tsell, tickets


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
    vals_lo: object = None
    palette_lo: object = None


@pytest.fixture
def x64():
    """The f64 tests run with jax_enable_x64 on and restore the flag."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", was)


#: columns of the windowed streams: past V2_MAX_N, the last window ragged
WIDE_N = 2_500_000


def _reference(pk, x, slot_mode):
    pal = np.tile((pk.palette if pk.palette is not None
                   else np.zeros(128, np.float32))[None, :], (8, 1))
    if pk.n > tsell.V2_MAX_N:
        # the windowed kernels: K6 (slot mode), K5 with values (row mode)
        kw = dict(g=pk.g, value_mode=pk.value_mode, nsteps=pk.nsteps,
                  nslices=pk.nslices, n=pk.n, interpret=True)
        args = (jnp.asarray(pk.tinfo), jnp.asarray(pk.ginfo),
                jnp.asarray(x), jnp.asarray(pk.meta),
                None if pk.vals is None else jnp.asarray(pk.vals),
                jnp.asarray(pal))
        out = (_run_v2w_slot(*args, nw=pk.nw, cell_w=pk.cell_w, **kw)
               if slot_mode else _run_v2w(*args, **kw))
        return np.asarray(out, dtype=np.float64).reshape(-1)
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


def _random_stream(slot_mode, nw, cell_w, value_mode, g, seed, n=None):
    """Random meta (every bit pattern), tinfo and monotone ginfo that
    visits every output block: valid kernel input, whatever a packer
    would emit.  The double-float modes get random hi planes and random
    lo planes (f32, int16 quanta, or a second palette).  Its columns span
    three bundles unless ``n`` is given; the last bundle is ragged."""
    rng = np.random.default_rng(seed)
    nblocks, nsteps = 3, 7
    nslices = nblocks if slot_mode else 8 * nblocks
    n = 3 * 1024 * nw - 300 if n is None else n
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
    vals = pal = vals_lo = pal_lo = None
    v = rng.standard_normal((ntiles, 8, 128)).astype(np.float32)
    if value_mode in ("palette", "palette_df"):
        pal = np.zeros(128, np.float32)
        pal[1:64] = rng.standard_normal(63)
        if value_mode == "palette_df":
            pal_lo = np.zeros(128, np.float32)
            pal_lo[1:64] = pal[1:64] * rng.uniform(-2 ** -24, 2 ** -24, 63)
    elif value_mode == "bf16":
        vals = v.astype(ml_dtypes.bfloat16)
    else:
        vals = v
    if value_mode == "df":
        vals_lo = (v * rng.uniform(-2 ** -24, 2 ** -24, v.shape)).astype(
            np.float32)
    elif value_mode == "df16":
        vals_lo = rng.integers(-32767, 32768, v.shape).astype(np.int16)
    return _Stream(m=nblocks * 1024, n=n, nslices=nslices, g=g,
                   nsteps=nsteps, value_mode=value_mode, tinfo=tinfo,
                   ginfo=(blocks << 1 | first).astype(np.int32), meta=meta,
                   vals=vals, palette=pal, nw=nw, cell_w=cell_w,
                   vals_lo=vals_lo, palette_lo=pal_lo)


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


@pytest.mark.parametrize("slot_mode,nw,cell_w,value_mode,g", [
    (False, 1, False, "f32", 2),
    (False, 1, False, "bf16", 3),
    (False, 1, False, "palette", 2),
    (True, 1, False, "f32", 2),
    (True, 1, False, "palette", 3),
    (True, 2, False, "bf16", 2),
    (True, 2, True, "palette", 2),
])
def test_random_windowed_stream_matches_tpu_kernel(slot_mode, nw, cell_w,
                                                   value_mode, g):
    # past 2M columns: tiles of random bundles across all 2.5M columns
    # against K5 (row mode, with values) and K6 (slot mode)
    pk = _random_stream(slot_mode, nw, cell_w, value_mode, g, seed=nw + g,
                        n=WIDE_N)
    st = tsell.prepare_sell(pk, "cpu", slot_mode)
    assert tsell.kernel_name(st) == ("sell_slot_w" if slot_mode
                                     else "sell_row_w")
    _check(pk, slot_mode)


def _wide_pattern(g, slot_mode, seed):
    """2048 rows of 6 nonzeros past 2M columns that pack at a modest pad:
    slot mode, half of them in the first 16 windows and half in 16 windows
    near column 2.48M; row mode, each 128-row slice's in one window of its
    own, spread over the columns."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(2048), 6)
    if slot_mode:
        cols = rng.integers(0, 16384, rows.size)
        cols[1::2] += 2_480_000
    else:
        cols = (rows // 128) * 150 * 1024 + rng.integers(0, 1024, rows.size)
    return g.CsrMatrix.from_coo(2048, WIDE_N, rows, cols,
                                rng.standard_normal(rows.size)
                                .astype(np.float32))


def _revalued(a, value_mode, entries, seed):
    """``a``'s pattern with values the packers store as ``value_mode``."""
    rng = np.random.default_rng(seed)
    if value_mode == "palette":
        v = (np.arange(1, entries) / 8.0)[rng.integers(0, entries - 1,
                                                       a.nnz)]
    elif value_mode == "bf16":
        v = rng.integers(1, 256, a.nnz) / 32.0
    else:
        v = rng.standard_normal(a.nnz)
    return JaxCsr(a.m, a.n, a.rowptr, a.colidx, v.astype(np.float32))


@pytest.mark.parametrize("values", ["palette", "bf16", "f32"])
def test_windowed_row_mode_on_packed_streams(values):
    # K5 with values: the sell8w_v2w stream of a pack past 2M columns
    a = _revalued(_wide_pattern(generate, False, 7), values, 64, 8)
    v2 = plan_v2(pack_sell8w(a, max_pad_ratio=8.0))
    assert v2.value_mode == values and v2.n > tsell.V2_MAX_N
    _check(v2, slot_mode=False)


@pytest.mark.parametrize("nw,cell_w,values", [(1, False, "palette"),
                                              (2, False, "f32"),
                                              (2, True, "bf16")])
def test_windowed_slot_mode_on_packed_streams(nw, cell_w, values):
    # K6: a windowed SELL-8D pack (one stream past 2M columns)
    a = _revalued(_wide_pattern(generate, True, nw), values,
                  64 >> (nw.bit_length() - 1), nw)
    pk, _rest = pack_sell8d(a, g="auto", max_pad_ratio=256.0,
                            max_spill=0.05, nw=nw, cell_w=cell_w)
    assert (pk.nw, pk.cell_w, pk.value_mode) == (nw, cell_w, values)
    assert pk.g in (8, 16)          # the windowed choice of g
    _check(pk, slot_mode=True)


def test_decoded_columns_past_int32():
    # one slot-mode tile whose bundle index is 2^28 - 1 at nw = 8: its
    # columns pass 2^40, decoded exactly in int64 as the kernel computes
    # them (int64(tinfo >> 3) * nw * 1024 + 1024 * wsel + 128 * s + r)
    meta = np.zeros((1, 8, 128), np.uint16)
    meta[0, 2, 9] = (5 << 10) | (3 << 7) | 9
    pk = _Stream(m=1024, n=1 << 42, nslices=1, g=1, nsteps=1,
                 value_mode="f32",
                 tinfo=np.array([((1 << 28) - 1) << 3], np.int32),
                 ginfo=np.ones(1, np.int32), meta=meta.view(np.int16),
                 vals=np.ones((1, 8, 128), np.float32), palette=None, nw=8)
    st = tsell.prepare_sell(pk, "cpu", True)
    assert tsell.kernel_name(st) == "sell_slot_w"
    rows, col, _v = tsell.sell_decode(st)
    assert col.dtype == torch.int64
    assert int(col[0, 2, 9]) == ((1 << 28) - 1) * 8 * 1024 + 5 * 1024 \
        + 3 * 128 + 9
    assert int(rows[0, 2, 9]) == 2 * 128 + 9


def test_plain_version_in_tile_chunks(monkeypatch):
    # the plain version decodes PLAIN_TILES tiles at a time: the same
    # sums as one pass, whatever the cut
    pk = _random_stream(True, 2, True, "f32", 3, seed=4)
    st = tsell.prepare_sell(pk, "cpu", True)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(pk.n)
                         .astype(np.float32))
    whole = tsell.sell_plain(st, x)
    monkeypatch.setattr(tsell, "PLAIN_TILES", 4)
    cut = tsell.sell_plain(st, x)
    absb = tsell.sell_plain(dataclasses.replace(st, vals=st.vals.abs()),
                            x.abs())
    assert bool(((cut - whole).abs() <= 1e-6 * absb + 1e-30).all())


def test_chunk_tables_cut_inside_blocks():
    # 24 one-tile steps on 2 SMs: chunks of 24 // (2 * CHUNKS_PER_SM) = 6
    # tiles, cut again where an output block ends; block 3 has no step and
    # gets one empty chunk (it writes its zeros)
    step_block = np.array([0] * 16 + [1] * 5 + [2] * 3)
    assert tsell.CHUNKS_PER_SM == 2 and tsell.chunk_len(24, 2) == 6
    csp, cb, bcp = tsell.chunk_tables(step_block, 4, g=1, nsm=2)
    assert csp.tolist() == [0, 6, 12, 16, 21, 24, 24]
    assert cb.tolist() == [0, 0, 0, 1, 2, 3]
    assert bcp.tolist() == [0, 3, 4, 5, 6]
    with pytest.raises(ValueError):
        tsell.chunk_tables(np.array([0, 1, 0]), 2, g=16, nsm=132)


def _shard_steps(ntiles, nblocks, g, seed):
    """A monotone step → output-block map of ntiles // g steps over
    nblocks blocks, some of them left without a step."""
    rng = np.random.default_rng(seed)
    nsteps = ntiles // g
    used = np.sort(rng.choice(nblocks, max(nblocks * 3 // 4, 1),
                              replace=False))
    return np.sort(used[rng.integers(0, len(used), nsteps)])


@pytest.mark.parametrize("ntiles,nblocks,g", [
    (2952, 49, 1),        # a shard of clustered200k's 4-shard 8W plan
    (20_623, 160, 1),     # webbase1m's heavy v1 stream
    (453_312, 244, 16),   # uniform250k_4m_d64 as one windowed slot stream
    (14_208, 7, 16),      # powerlaw100k's 8W part: few, long blocks
    (40_000, 2, 1),       # two output blocks: the reduce cap binds
    (60, 7, 2),           # short: one tile a chunk
])
def test_chunk_tables_grain(ntiles, nblocks, g):
    sb = _shard_steps(ntiles, nblocks, g, seed=ntiles)
    csp, cb, bcp = tsell.chunk_tables(sb, nblocks, g=g, nsm=132)
    nchunks = len(cb)
    # the chunks cover the stream in order, each inside one output block
    assert csp[0] == 0 and csp[-1] == len(sb) and np.all(np.diff(csp) >= 0)
    for c in range(nchunks):
        assert np.all(sb[csp[c]:csp[c + 1]] == cb[c])
    # every block has its chunks, contiguous, and only the blocks without
    # a step have an empty one
    assert bcp[0] == 0 and bcp[-1] == nchunks and np.all(np.diff(bcp) >= 1)
    np.testing.assert_array_equal(np.repeat(np.arange(nblocks),
                                            np.diff(bcp)), cb)
    empty = np.diff(csp) == 0
    np.testing.assert_array_equal(np.sort(cb[empty]),
                                  np.setdiff1d(np.arange(nblocks), sb))
    # chunks of the grain's steps, longer only where a block's run would
    # take more chunks than MAX_REDUCE_BYTES of f32 partial sums hold
    steps = max(tsell.chunk_len(ntiles, 132) // g, 1)
    most = tsell.MAX_REDUCE_BYTES // (1024 * 4)
    run = np.bincount(sb, minlength=nblocks)
    per = np.maximum(steps, -(-run // most))
    assert np.all(np.diff(csp) <= per[cb])
    np.testing.assert_array_equal(np.diff(bcp), np.maximum(-(-run // per),
                                                           1))
    assert np.diff(bcp).max() <= most
    if ntiles >= 2 * 132 and run.max() <= most * steps:
        assert nchunks >= 2 * 132     # two waves of one block an SM
    # f64 partial sums are twice the bytes: half the chunks an output block
    _csp, _cb, bcp64 = tsell.chunk_tables(sb, nblocks, g=g, nsm=132,
                                          esize=8)
    assert np.diff(bcp64).max() <= most // 2
    if ntiles == 2952:
        # the old fixed 64-tile chunks gave this shard about 50 blocks
        assert steps == 11 and 2 * 132 <= nchunks <= 2952 // 11 + 49


def test_wrapper_takes_no_other_device():
    pk = _random_stream(False, 1, False, "f32", 2, seed=0)
    st = tsell.prepare_sell(pk, "cpu", False)
    with pytest.raises(ValueError):
        tsell.sell_spmv(st, torch.empty(pk.n, device="meta"))
    # an f64 stream likewise, with its own x type
    pk = _random_stream(True, 2, True, "df16", 2, seed=0)
    st = tsell.prepare_sell(pk, "cpu", True)
    assert st.dtype == torch.float64 and st.vals_lo.dtype == torch.int16
    with pytest.raises(ValueError):
        tsell.sell_spmv(st, torch.empty(pk.n, dtype=torch.float64,
                                        device="meta"))


# -- f64: the double-float packs (K2) ---------------------------------------

def _reference_df(pk, x, slot_mode):
    """The TPU kernel _run_v2_df in interpret mode, or _run_v2w_df (K7)
    past 2M columns."""
    def tile(p):
        return jnp.asarray(np.tile((p if p is not None else np.zeros(
            128, np.float32))[None, :], (8, 1)))

    pal = pk.value_mode == "palette_df"
    dummy = jnp.zeros((8, 128), jnp.float32)
    run = _run_v2w_df if pk.n > tsell.V2_MAX_N else _run_v2_df
    out = run(jnp.asarray(pk.tinfo), jnp.asarray(pk.ginfo),
                     jnp.asarray(x), jnp.asarray(pk.meta),
                     dummy if pal else jnp.asarray(pk.vals),
                     dummy if pal else jnp.asarray(pk.vals_lo),
                     tile(pk.palette), tile(pk.palette_lo), g=pk.g,
                     palette=pal, nsteps=pk.nsteps, nslices=pk.nslices,
                     n=pk.n, interpret=True, slot_mode=slot_mode,
                     nw=getattr(pk, "nw", 1),
                     vlo16=pk.value_mode == "df16",
                     cell_w=bool(getattr(pk, "cell_w", False)))
    return np.asarray(out, dtype=np.float64).reshape(-1)


def _numpy_df(pk, x, slot_mode, absolute=False):
    """An exact numpy f64 decode of the pack: every slot's column and
    f64 value, the products added into their rows."""
    meta = pk.meta.view(np.uint16).astype(np.int64)
    r = meta & 127
    cell = np.take_along_axis(meta, r, axis=2)
    s = (cell >> 7) & 7
    ti = pk.tinfo.astype(np.int64)[:, None, None]
    nw = getattr(pk, "nw", 1) if slot_mode else 1
    lb = nw.bit_length() - 1
    if slot_mode:
        w = ((cell if pk.cell_w else meta) >> 10) & (nw - 1)
        col = (ti >> 3) * nw * 1024 + w * 1024 + s * 128 + r
    else:
        col = (ti >> 3) * 1024 + s * 128 + r
    if pk.value_mode == "palette_df":
        code = (meta >> (10 + lb)) & (63 >> lb)
        v = (pk.palette.astype(np.float64)[code]
             + pk.palette_lo.astype(np.float64)[code])
    elif pk.value_mode == "df":
        v = pk.vals.astype(np.float64) + pk.vals_lo.astype(np.float64)
    else:
        pulse = (pk.vals.view(np.int32) & 0x7F800000).view(np.float32)
        scale = (pulse * np.float32(2.0 ** -39)).astype(np.float64)
        v = pk.vals.astype(np.float64) + pk.vals_lo.astype(np.float64) * scale
    xv = np.where(col < pk.n, x[np.minimum(col, pk.n - 1)], 0.0)
    prod = v * xv
    if absolute:
        prod = np.abs(v) * np.abs(xv)
    block = np.repeat(pk.ginfo.astype(np.int64) >> 1, pk.g)[:, None]
    lane = np.arange(128)
    nblocks = pk.nslices if slot_mode else -(-pk.nslices // 8)
    out = np.zeros(nblocks * 1024)
    if slot_mode:
        rows = block[:, :, None] * 1024 + np.arange(8)[:, None] * 128 + lane
        np.add.at(out, rows.reshape(-1), prod.reshape(-1))
    else:
        rows = block * 1024 + (ti[:, 0] & 7) * 128 + lane
        np.add.at(out, rows.reshape(-1), prod.sum(1).reshape(-1))
    return out


def _check_df(pk, slot_mode, x=None):
    if x is None:
        x = np.random.default_rng(0).standard_normal(pk.n)
    st = tsell.prepare_sell(pk, "cpu", slot_mode)
    y = tsell.sell_spmv(st, torch.from_numpy(x))
    assert y.dtype == torch.float64
    y = y.numpy()
    bound = _numpy_df(pk, x, slot_mode, absolute=True) + 1e-300
    exact = _numpy_df(pk, x, slot_mode)
    assert y.shape == exact.shape
    np.testing.assert_array_less(np.abs(y - exact), 1e-12 * bound)
    ref = _reference_df(pk, x, slot_mode)
    np.testing.assert_array_less(np.abs(y - ref), 2e-6 * bound)
    return y


@pytest.mark.parametrize("slot_mode,nw,cell_w,value_mode,g", [
    (False, 1, False, "df", 2),
    (False, 1, False, "df16", 3),
    (False, 1, False, "palette_df", 2),
    (True, 1, False, "df16", 2),
    (True, 2, False, "df", 2),
    (True, 2, True, "palette_df", 2),
    (True, 4, False, "palette_df", 2),
    (True, 4, True, "df16", 3),
    (True, 8, False, "df", 2),
    (True, 8, True, "df16", 2),
    (True, 8, True, "palette_df", 2),
])
def test_random_df_stream_matches_tpu_kernel(slot_mode, nw, cell_w,
                                             value_mode, g, x64):
    pk = _random_stream(slot_mode, nw, cell_w, value_mode, g, seed=nw + g)
    _check_df(pk, slot_mode)


def _f64_values(a, value_mode, entries, seed):
    """``a``'s pattern with f64 values suited to ``value_mode``."""
    rng = np.random.default_rng(seed)
    if value_mode == "palette_df":
        v = rng.standard_normal(entries - 1)[rng.integers(0, entries - 1,
                                                          a.nnz)]
    else:
        v = rng.standard_normal(a.nnz) * np.exp(rng.uniform(-20, 20,
                                                            a.nnz))
    return JaxCsr(a.m, a.n, a.rowptr, a.colidx, v)


@pytest.mark.parametrize("value_mode", ["df", "df16", "palette_df"])
def test_row_mode_on_packed_df_streams(value_mode, x64):
    base = generate.with_empty_rows(
        generate.clustered(2000, 3000, 10, spread=300, dtype=np.float32,
                           seed=3), 0.3, seed=4)
    a = _f64_values(base, value_mode, 64, seed=5)
    hi = pack_sell8w(a)
    lo = pack_sell8w(JaxCsr(a.m, a.n, a.rowptr, a.colidx,
                            (a.vals - a.vals.astype(np.float32))
                            .astype(np.float32)))
    v2 = plan_v2(hi, g=4, lo_tiles=lo.vals, force_value_mode=value_mode)
    assert v2.value_mode == value_mode
    _check_df(v2, slot_mode=False)


@pytest.mark.parametrize("nw,cell_w,value_mode", [
    (1, False, "df16"), (2, False, "palette_df"), (2, True, "df"),
    (4, False, "df"), (4, True, "palette_df"), (8, False, "df16"),
    (8, True, "df16")])
def test_slot_mode_on_packed_df_streams(nw, cell_w, value_mode, x64):
    base = generate.random_uniform(2000, 20000, 6, dtype=np.float32,
                                   seed=nw)
    a = _f64_values(base, value_mode, 64 >> (nw.bit_length() - 1), seed=nw)
    pk, _rest = pack_sell8d(a, g=8, max_pad_ratio=256.0, max_spill=0.05,
                            nw=nw, cell_w=cell_w, force_value_mode=value_mode)
    assert (pk.nw, pk.cell_w, pk.value_mode) == (nw, cell_w, value_mode)
    _check_df(pk, slot_mode=True)


@pytest.mark.parametrize("slot_mode,nw,cell_w,value_mode,g", [
    (False, 1, False, "df", 2),
    (False, 1, False, "df16", 3),
    (False, 1, False, "palette_df", 2),
    (True, 1, False, "df16", 2),
    (True, 2, False, "palette_df", 2),
    (True, 2, True, "df", 3),
])
def test_random_windowed_df_stream_matches_tpu_kernel(slot_mode, nw, cell_w,
                                                      value_mode, g, x64):
    # K7, row and slot mode, over random tiles across 2.5M columns
    pk = _random_stream(slot_mode, nw, cell_w, value_mode, g, seed=nw + g,
                        n=WIDE_N)
    st = tsell.prepare_sell(pk, "cpu", slot_mode)
    assert tsell.kernel_name(st) == ("sell_slot_df_w" if slot_mode
                                     else "sell_row_df_w")
    _check_df(pk, slot_mode)


@pytest.mark.parametrize("slot_mode,value_mode", [(False, "df16"),
                                                  (True, "df16"),
                                                  (True, "palette_df")])
def test_windowed_df_packed_streams(slot_mode, value_mode, x64):
    # K7 on the JAX package's packs past 2M columns: the double SELL-8W
    # pack (hi, lo) as sell8w_v2w, and a windowed SELL-8D pack
    base = _wide_pattern(generate, slot_mode, 11)
    a = _f64_values(base, value_mode, 64, seed=12)
    if slot_mode:
        pk, _rest = pack_sell8d(a, g="auto", max_pad_ratio=256.0,
                                max_spill=0.05, nw=1,
                                force_value_mode=value_mode)
    else:
        hi = pack_sell8w(a, max_pad_ratio=8.0)
        lo = pack_sell8w(JaxCsr(a.m, a.n, a.rowptr, a.colidx,
                                (a.vals - a.vals.astype(np.float32))
                                .astype(np.float32)))
        pk = plan_v2(hi, lo_tiles=lo.vals)
    assert pk.value_mode == value_mode and pk.n > tsell.V2_MAX_N
    _check_df(pk, slot_mode)


# -- the v1 layout: one tile a step (K9, K10, K11) ---------------------------

def _v1_reference(st, x, binary=False):
    """The TPU's v1 kernels in interpret mode on the stream's own arrays:
    _run (K9, K11 with ``binary``) or _run_df_v1 (K10)."""
    args = (jnp.asarray(st.tinfo.numpy()), jnp.asarray(st.gpk.numpy()),
            jnp.asarray(x), jnp.asarray(st.meta.numpy()))
    kw = dict(ntiles=st.meta.shape[0], nslices=8 * st.nblocks, n=st.n,
              interpret=True)
    if st.value_mode == "df":
        out = _run_df_v1(*args, jnp.asarray(st.vals.numpy()),
                         jnp.asarray(st.vals_lo.numpy()), **kw)
    else:
        out = _run(*args, None if binary else jnp.asarray(st.vals.numpy()),
                   binary=binary, **kw)
    return np.asarray(out, dtype=np.float64).reshape(-1)


def _v1_bound(st, x):
    """(|A||x|) per output row of a v1 stream, by the plain version."""
    return tsell.sell_plain(dataclasses.replace(
        st, vals=None if st.vals is None else st.vals.abs(),
        vals_lo=None if st.vals_lo is None else st.vals_lo.abs()),
        torch.from_numpy(np.abs(x))).numpy().astype(np.float64)


def _check_v1(st, x, binary=False):
    y = tsell.sell_spmv(st, torch.from_numpy(x)).numpy()
    ref = _v1_reference(st, x, binary)
    assert y.shape == ref.shape
    np.testing.assert_array_less(np.abs(y - ref), 1e-5 * _v1_bound(st, x)
                                 + 1e-30)
    return y


def _random_v1(seed, binary=False, df=False, n=5000):
    """Random v1 arrays: sorted slice ids over 3 groups (every group
    visited), random windows below n, every meta bit pattern (so a slot's
    s differs from its cell's), random values."""
    rng = np.random.default_rng(seed)
    nslices, ntiles = 20, 40
    sl = np.sort(np.concatenate([np.arange(0, nslices, 8),
                                 rng.integers(0, nslices, ntiles - 3)]))
    win = rng.integers(0, -(-n // 1024), ntiles).astype(np.int32)
    meta = rng.integers(0, 1 << 16, (ntiles, 8, 128)).astype(
        np.uint16).view(np.int16)
    v = rng.standard_normal((ntiles, 8, 128)).astype(np.float32)
    lo = ((v * rng.uniform(-2 ** -24, 2 ** -24, v.shape)).astype(np.float32)
          if df else None)
    return tsell.prepare_v1(win, tsell.pack_gpk(sl), meta,
                            None if binary else v, nslices, nslices * 128,
                            n, "cpu", vals_lo=lo)


def test_pack_gpk_is_the_reference_layout():
    sl = np.array([0, 0, 3, 7, 8, 8, 15, 16, 23, 40])
    np.testing.assert_array_equal(tsell.pack_gpk(sl), pack_gpk(sl))
    assert tsell.pack_gpk(sl).dtype == pack_gpk(sl).dtype


@pytest.mark.parametrize("binary", [False, True])
def test_v1_random_stream_matches_tpu_kernel(binary):
    st = _random_v1(3, binary=binary)
    assert tsell.kernel_name(st) == ("sell_v1_bin" if binary else "sell_v1")
    x = np.random.default_rng(1).standard_normal(st.n).astype(np.float32)
    _check_v1(st, x, binary)


def test_v1_s_is_read_at_the_cell():
    # one v1 tile: slot (2, 3) names residue r=5 and carries s=1 itself;
    # the cell (2, 5) says s=3 — the cell wins, as in _kernel's two gathers
    meta = np.zeros((1, 8, 128), np.uint16)
    meta[0, 2, 3] = (1 << 7) | 5
    meta[0, 2, 5] = (3 << 7) | 5
    vals = np.zeros((1, 8, 128), np.float32)
    vals[0, 2, 3] = 2.0
    x = np.zeros(4096, np.float32)
    x[2048 + 3 * 128 + 5] = 7.0
    st = tsell.prepare_v1(np.array([2], np.int32),
                          tsell.pack_gpk(np.array([5])),
                          meta.view(np.int16), vals, 8, 1024, 4096, "cpu")
    y = _check_v1(st, x)
    assert y[5 * 128 + 3] == 14.0 and np.count_nonzero(y) == 1


def test_v1_packed_stream_matches_tpu_kernel_and_v2():
    # K9 on a packed stream, through build_sell8w_fn as both packages
    # build it, and the same pack as a v2 row-mode stream: the same y
    from spmv_tpu.ops.pallas_sell import build_sell8w_fn
    a = generate.with_empty_rows(
        generate.clustered(3000, 5000, 12, spread=300, dtype=np.float32,
                           seed=3, exact=False), 0.3, seed=4)
    pk = pack_sell8w(a)
    x = np.random.default_rng(2).standard_normal(a.n).astype(np.float32)
    y = tsell.build_sell8w_fn(pk, device="cpu")(torch.from_numpy(x))
    ref = np.asarray(build_sell8w_fn(pk, interpret=True)(jnp.asarray(x)),
                     dtype=np.float64)
    st = tsell.prepare_v1(pk.window_ids, tsell.pack_gpk(pk.slice_ids),
                          pk.meta, pk.vals, pk.nslices, pk.m, pk.n, "cpu")
    bound = _v1_bound(st, x)[:a.m]
    np.testing.assert_array_less(np.abs(y.numpy() - ref), 1e-5 * bound
                                 + 1e-30)
    v2 = tsell.prepare_sell(plan_v2(pk, g=4), "cpu", slot_mode=False)
    y2 = tsell.sell_spmv(v2, torch.from_numpy(x))[:a.m].numpy()
    np.testing.assert_array_less(np.abs(y.numpy() - y2), 1e-5 * bound
                                 + 1e-30)
    np.testing.assert_allclose(
        tsell.sell8w_spmv(pk, torch.from_numpy(x)).numpy(), y.numpy())


def test_v1_binary_matches_tpu_kernel():
    # K11: build_sell8w_fn(binary=True) over a 0/1 pattern with explicit
    # zeros (padding by value), x not finite where no valid slot reads it
    from spmv_tpu.ops.pallas_sell import build_sell8w_fn
    a = generate.clustered(2000, 3000, 10, spread=200, dtype=np.float32,
                           seed=5)
    rng = np.random.default_rng(6)
    v = (rng.random(a.nnz) < 0.8).astype(np.float32)
    a = JaxCsr(a.m, a.n, a.rowptr, a.colidx, v)
    pk = pack_sell8w(a)
    x = rng.standard_normal(a.n).astype(np.float32)
    unread = np.setdiff1d(np.arange(a.n), a.colidx[v != 0])
    x[unread[:5]] = np.nan
    y = tsell.build_sell8w_fn(pk, binary=True, device="cpu")(
        torch.from_numpy(x)).numpy()
    ref = np.asarray(build_sell8w_fn(pk, interpret=True, binary=True)(
        jnp.asarray(x)), dtype=np.float64)
    assert np.isfinite(y).all() and np.isfinite(ref).all()
    absx = np.abs(np.nan_to_num(x))
    bound = tsell.build_sell8w_fn(pk, binary=True, device="cpu")(
        torch.from_numpy(absx)).numpy()
    np.testing.assert_array_less(np.abs(y - ref), 1e-5 * bound + 1e-30)


def test_v1_dist_padding_tiles():
    # a dist pack's padding tiles (mesh.py:719-721): window 0, zero meta
    # and values, gpk = (ngroups - 1) << 4 (first = 0).  They add 0·x[0]
    # into the last group's row 0: NaN there when x[0] is not finite, on
    # the TPU as well
    a = generate.clustered(1500, 2000, 8, spread=200, dtype=np.float32,
                           seed=7, exact=False)
    pk = pack_sell8w(a)
    pad = 6
    ngroups = -(-pk.nslices // 8)
    win = np.concatenate([pk.window_ids, np.zeros(pad, np.int32)])
    gpk = np.concatenate([pack_gpk(pk.slice_ids),
                          np.full(pad, (ngroups - 1) << 4, np.int32)])
    meta = np.concatenate([pk.meta, np.zeros((pad, 8, 128), np.int16)])
    vals = np.concatenate([pk.vals, np.zeros((pad, 8, 128), np.float32)])
    st = tsell.prepare_v1(win, gpk, meta, vals, pk.nslices, pk.m, pk.n,
                          "cpu")
    x = np.random.default_rng(8).standard_normal(a.n).astype(np.float32)
    _check_v1(st, x)
    x[0] = np.inf
    y = tsell.sell_spmv(st, torch.from_numpy(x)).numpy()
    ref = _v1_reference(st, x)
    np.testing.assert_array_equal(np.isnan(y), np.isnan(ref))
    assert np.isnan(y[(ngroups - 1) * 1024:(ngroups - 1) * 1024 + 128]).all()


@pytest.mark.parametrize("df", [False, True])
def test_v1_past_2_21_columns(df, x64):
    # 4096 rows over 2.5M columns: windows past 2^11, columns past 2^21
    rng = np.random.default_rng(9)
    rows = np.repeat(np.arange(4096), 4)
    cols = (rows // 128) * 75 * 1024 + rng.integers(0, 2048, rows.size)
    v = rng.standard_normal(rows.size)
    a = JaxCsr.from_coo(4096, WIDE_N, rows, cols, v)
    assert a.colidx.max() > 1 << 21
    hi = pack_sell8w(JaxCsr(a.m, a.n, a.rowptr, a.colidx,
                            a.vals.astype(np.float32)))
    lo = None
    if df:
        lo = pack_sell8w(JaxCsr(a.m, a.n, a.rowptr, a.colidx,
                                (a.vals - a.vals.astype(np.float32))
                                .astype(np.float32))).vals
    st = tsell.prepare_v1(hi.window_ids, tsell.pack_gpk(hi.slice_ids),
                          hi.meta, hi.vals, hi.nslices, hi.m, hi.n, "cpu",
                          vals_lo=lo)
    assert tsell.kernel_name(st) == ("sell_v1_df" if df else "sell_v1")
    x = rng.standard_normal(a.n)
    if not df:
        _check_v1(st, x.astype(np.float32))
        return
    # K10: exact against the f64 row sums of hi + lo, 2e-6 against the
    # interpret-mode kernel (its EFTs collapse to about f32 accuracy)
    y = tsell.sell_spmv(st, torch.from_numpy(x))
    assert y.dtype == torch.float64
    y = y.numpy()[:a.m]
    v64 = a.vals.astype(np.float32).astype(np.float64) + (
        a.vals - a.vals.astype(np.float32)).astype(np.float32)
    prod = v64 * x[a.colidx]
    exact = np.zeros(a.m)
    np.add.at(exact, np.repeat(np.arange(a.m), a.row_lengths), prod)
    bound = np.zeros(a.m)
    np.add.at(bound, np.repeat(np.arange(a.m), a.row_lengths), np.abs(prod))
    np.testing.assert_array_less(np.abs(y - exact), 1e-12 * bound + 1e-300)
    ref = _v1_reference(st, x)[:a.m]
    np.testing.assert_array_less(np.abs(y - ref), 2e-6 * bound + 1e-300)


def test_v1_random_df_stream_matches_tpu_kernel(x64):
    st = _random_v1(4, df=True)
    assert tsell.kernel_name(st) == "sell_v1_df" and st.dtype == torch.float64
    x = np.random.default_rng(2).standard_normal(st.n)
    y = tsell.sell_spmv(st, torch.from_numpy(x)).numpy()
    bound = _v1_bound(st, x) + 1e-300
    ref = _v1_reference(st, x)
    np.testing.assert_array_less(np.abs(y - ref), 2e-6 * bound)


# -- chunk tables, tickets and partials (the kernel's one-launch epilogue) --

def _chunked_plain(st, x, order):
    """The kernel's arithmetic, chunk by chunk, on the plain decode: each
    chunk's 1024 sums, then its epilogue in completion ``order``: a block
    with one chunk writes its rows; otherwise each chunk writes partial row
    c and takes a ticket, and the last adds rows block_chunk_ptr[b] ..
    [b + 1] in chunk order and resets the ticket.  Returns (out, ticket)."""
    csp = st.chunk_step_ptr.numpy().astype(np.int64) * st.g
    cb = st.chunk_block.numpy()
    bcp = st.block_chunk_ptr.numpy()
    ticket = tickets(st, ("cpu", 0)).numpy().copy()
    sums = []
    for c in range(len(cb)):
        acc = torch.zeros(1024, dtype=st.dtype)
        if csp[c + 1] > csp[c]:
            rows, col, v = tsell.sell_decode(st, int(csp[c]),
                                             int(csp[c + 1]))
            xg = torch.where(col < st.n, x[col.clamp(max=st.n - 1)], 0.0)
            prod = (torch.where(v != 0, xg, 0.0)
                    if st.value_mode == "binary" else v * xg)
            rows = rows - int(cb[c]) * 1024
            if st.slot_mode:
                acc.index_add_(0, rows.reshape(-1), prod.reshape(-1))
            else:
                acc.index_add_(0, rows[:, 0].reshape(-1),
                               prod.sum(1).reshape(-1))
        sums.append(acc)
    partial = torch.full((len(cb), 1024), float("nan"), dtype=st.dtype)
    out = torch.full((st.nblocks, 1024), float("nan"), dtype=st.dtype)
    for c in order:
        b = cb[c]
        if bcp[b + 1] - bcp[b] == 1:
            out[b] = sums[c]
            continue
        partial[c] = sums[c]
        ticket[b] += 1
        if ticket[b] == bcp[b + 1] - bcp[b]:
            total = torch.zeros(1024, dtype=st.dtype)
            for cc in range(bcp[b], bcp[b + 1]):
                total = total + partial[cc]
            out[b] = total
            ticket[b] = 0
    return out.reshape(-1), ticket


@pytest.mark.parametrize("kind", ["slot", "row", "v1", "v1_bin", "slot_df"])
def test_ticket_and_partials_layout(kind, request):
    # one-tile chunks (these short streams on 64 SMs) so output blocks
    # have several; every completion order gives the same bits, leaves the
    # tickets at 0, and matches the TPU kernel in interpret mode
    if kind.startswith("v1"):
        v1 = _random_v1(5, binary=kind == "v1_bin")
        st = tsell.prepare_v1(v1.tinfo.numpy(), v1.gpk.numpy(),
                              v1.meta.numpy(), None if v1.vals is None
                              else v1.vals.numpy(), 8 * v1.nblocks,
                              v1.m, v1.n, "cpu", nsm=64)
    else:
        if kind == "slot_df":
            request.getfixturevalue("x64")
        pk = _random_stream(kind != "row", 1 if kind == "row" else 2,
                            kind != "row", "df16" if kind == "slot_df"
                            else "f32", 3, seed=11)
        st = tsell.prepare_sell(pk, "cpu", kind != "row", nsm=64)
    ticket = tickets(st, ("cpu", 0))
    assert ticket.dtype == torch.int32 and ticket.shape == (
        st.nblocks,) and not bool(ticket.any())
    assert np.diff(st.block_chunk_ptr.numpy()).max() > 1
    rng = np.random.default_rng(0)
    x = rng.standard_normal(st.n).astype(
        np.float64 if st.dtype == torch.float64 else np.float32)
    xt = torch.from_numpy(x)
    nch = st.nchunks
    y0, t0 = _chunked_plain(st, xt, range(nch))
    y1, t1 = _chunked_plain(st, xt, rng.permutation(nch))
    y2, _ = _chunked_plain(st, xt, range(nch - 1, -1, -1))
    assert bool(torch.equal(y0, y1)) and bool(torch.equal(y0, y2))
    assert not t0.any() and not t1.any()
    y0 = y0.numpy()
    if kind.startswith("v1"):
        ref, bound, tol = (_v1_reference(st, x, binary=kind == "v1_bin"),
                           _v1_bound(st, x), 1e-5)
    elif kind == "slot_df":
        bound = _numpy_df(pk, x, True, absolute=True) + 1e-300
        np.testing.assert_array_less(np.abs(y0 - _numpy_df(pk, x, True)),
                                     1e-12 * bound)
        ref, tol = _reference_df(pk, x, True), 2e-6
    else:
        ref, tol = _reference(pk, x, kind != "row"), 1e-5
        bound = tsell.sell_plain(dataclasses.replace(
            st, vals=st.vals.abs()), xt.abs()).numpy()
    np.testing.assert_array_less(np.abs(y0 - ref), tol * bound + 1e-30)
    # the plain version, which ignores the chunks, gives the same sums
    np.testing.assert_array_less(
        np.abs(tsell.sell_plain(st, xt).numpy() - y0),
        (1e-12 if kind == "slot_df" else 1e-5) * bound + 1e-30)
