"""The port's fixed-order sums against the ``index_add_`` they replace, on
the CPU.

On the card ``index_add_`` over repeated indices adds with float atomics
and a 1-D ``torch.cumsum`` with a look-back scan, so a plan built on them
need not repeat its own y.  Each site now sums in one fixed order
(``ops/torch_csr.py``: ``segment_sum``, ``fold_add``, ``prefix_sum``).  On
the CPU both orders are the stream order, so every rewritten site must
give the old result bit for bit (``torch.equal``), in f32, in f64 and with
bf16 values upcast to f32: the Serial plan, the chunked SELL-C-σ plan,
BCSR, the straggler stream, the mega-row fold and a mesh plan's straggler
rows.  The prefix sum (rows of ``SCAN_ROW`` plus a carry past ``ONE_ROW``,
on every device)
adds in another order than ``torch.cumsum``: it is held to it bit for bit
on integer values, where every order is exact, and within 1e-12 of the
largest prefix magnitude in f64 otherwise; the scan plans through it within
1e-12 of sum|a|·max|x| of their ``cumsum`` results.
"""

import numpy as np
import pytest
import torch

from spmv_tpu_torch import handle as th
from spmv_tpu_torch.formats import bcsr as bcsr_fmt
from spmv_tpu_torch.formats import partition
from spmv_tpu_torch.formats import sell as sell_fmt
from spmv_tpu_torch.io import generate
from spmv_tpu_torch.ops import torch_csr
from spmv_tpu_torch.parallel import mesh as pm

#: value types: the values' type, x's type (bf16 values upcast to f32)
DTYPES = {"f32": (torch.float32, torch.float32),
          "f64": (torch.float64, torch.float64),
          "bf16": (torch.bfloat16, torch.float32)}


def _vals(rng, n, dtype):
    """n values in ``dtype`` whose magnitudes span 1e-3 to 1e3."""
    v = rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)
    return torch.from_numpy(v).to(dtype)


def _x(rng, n, dtype):
    return torch.from_numpy(rng.standard_normal(n)).to(dtype)


def _matrix(seed):
    """A power-law matrix with empty rows and long rows."""
    return generate.with_empty_rows(
        generate.power_law(700, 600, 9000, dtype=np.float64, seed=seed),
        0.3, seed=seed)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_serial_matches_index_add(dt):
    vdt, xdt = DTYPES[dt]
    rng = np.random.default_rng(1)
    a = _matrix(1)
    rows = torch.from_numpy(partition.row_ids(a).astype(np.int64))
    cols = torch.from_numpy(a.colidx.astype(np.int64))
    vals, x = _vals(rng, a.nnz, vdt), _x(rng, a.n, xdt)
    new = torch_csr.segment_sum_spmv(torch_csr.segment_lengths(rows, a.m),
                                     cols, vals, x)
    prod = vals.to(xdt) * x[cols]
    old = torch.zeros(a.m, dtype=xdt).index_add_(0, rows, prod)
    assert new.dtype == xdt and torch.equal(new, old)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("sigma", [1, 4096])
def test_chunked_sell_matches_index_add(dt, sigma):
    vdt, xdt = DTYPES[dt]
    rng = np.random.default_rng(2)
    a = _matrix(2)
    s = sell_fmt.pack_sell(a, sigma=sigma)
    cols = torch.from_numpy(np.asarray(s.cols).astype(np.int64))
    ids = torch.from_numpy(np.asarray(s.chunk_ids).astype(np.int64))
    inv = torch.from_numpy(np.asarray(s.inv_pos).astype(np.int64))
    vals, x = _vals(rng, cols.numel(), vdt).view(cols.shape), _x(rng, a.n,
                                                                  xdt)
    lens = torch_csr.segment_lengths(ids, s.nslices)
    assert int(lens.max()) > 1          # slices of several chunks
    new = torch_csr.sell_spmv(cols, vals, lens, inv, x,
                              identity_order=s.identity_order)
    part = (vals.to(xdt) * x[cols]).sum(dim=1)
    y_all = torch.zeros(s.nslices, part.shape[1], dtype=xdt).index_add_(
        0, ids, part).reshape(-1)
    old = y_all[:inv.shape[0]] if s.identity_order else y_all[inv]
    assert torch.equal(new, old)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_bcsr_matches_index_add(dt):
    vdt, _xdt = DTYPES[dt]
    acc = torch.float64 if vdt == torch.float64 else torch.float32
    rng = np.random.default_rng(3)
    a = generate.block_random(5, 6, blocks_per_row=3, fill=0.5,
                              dtype=np.float64, seed=3)
    b = bcsr_fmt.pack_bcsr(a)
    nbr = -(-a.m // bcsr_fmt.BLOCK)
    brows = torch.from_numpy(np.asarray(b.block_rows).astype(np.int64))
    bcols = torch.from_numpy(np.asarray(b.block_cols).astype(np.int64))
    blocks = _vals(rng, int(np.prod(b.blocks.shape)), vdt).view(
        b.blocks.shape)
    x = _x(rng, a.n, acc)
    new = torch_csr.bcsr_spmv(blocks, torch_csr.segment_lengths(brows, nbr),
                              bcols, x, m=a.m)
    bs = bcsr_fmt.BLOCK
    xp = torch.cat([x, x.new_zeros(-(-a.n // bs) * bs - a.n)])
    partial = torch.mul(blocks, xp.view(-1, bs)[bcols][:, None, :]).sum(
        dim=2, dtype=acc)
    old = torch.zeros(nbr, bs, dtype=acc).index_add_(
        0, brows, partial).reshape(-1)[:a.m]
    assert torch.equal(new, old)


def _repeated_rows(rng, m, n):
    """n row ids over m rows, unsorted, each touched row repeating."""
    return rng.integers(0, m // 4, size=n) * 4 + 1


@pytest.mark.parametrize("dt", list(DTYPES))
def test_straggler_stream_matches_index_add(dt):
    vdt, xdt = DTYPES[dt]
    rng = np.random.default_rng(4)
    m, n, k = 500, 400, 3000
    rows = _repeated_rows(rng, m, k)
    cols = rng.integers(0, n, size=k)
    vals = _vals(rng, k, vdt)
    vals_host = (vals.view(torch.int16).numpy().view(np.uint16)
                 if vdt == torch.bfloat16 else vals.numpy())
    r = th._prepare_rest(rows, cols, vals_host, "cpu")
    assert r["vals"].dtype == vdt
    x, y0 = _x(rng, n, xdt), _x(rng, m, xdt)
    new = th.add_rest(r, x, y0.clone())
    # the old sums: per row on the compact domain, then into y
    order = np.argsort(rows, kind="stable")
    rs = rows[order]
    first = np.r_[True, rs[1:] != rs[:-1]]
    seg = torch.from_numpy(np.cumsum(first) - 1)
    prod = vals[order].to(xdt) * x[torch.from_numpy(cols[order])]
    sums = torch.zeros(int(first.sum()), dtype=xdt).index_add_(0, seg, prod)
    old = y0.clone().index_add_(0, torch.from_numpy(rs[first]), sums)
    assert torch.equal(new, old)
    assert th.add_rest(th._prepare_rest(rows[:0], cols[:0], vals_host[:0],
                                        "cpu"), x, y0.clone()).equal(y0)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_mega_row_fold_matches_index_add(dt):
    """The mega-row fold adds virtual sub-rows (repeated origin rows) into
    y; y is in x's type, as the SELL kernels give it (the SELL-8W plans
    that split mega-rows take f32 and f64 matrices only, so no bf16)."""
    _vdt, xdt = DTYPES[dt]
    rng = np.random.default_rng(5)
    m, nsub = 300, 2000
    sub = np.sort(_repeated_rows(rng, m, nsub))
    y = _vals(rng, m + nsub, xdt)
    fold = torch_csr.fold_plan(sub, "cpu")
    new = torch_csr.fold_add(y.clone()[:m], fold, y[m:])
    old = y.clone()[:m].index_add_(0, torch.from_numpy(sub), y[m:])
    assert torch.equal(new, old)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_mesh_stragglers_match_index_add(dt):
    vdt, xdt = DTYPES[dt]
    rng = np.random.default_rng(6)
    m, n, k = 640, 640, 2500
    rows = _repeated_rows(rng, m, k)
    cols = rng.integers(0, n, size=k)
    vals = _vals(rng, k, vdt)
    vals_host = (vals.view(torch.int16).numpy().view(np.uint16)
                 if vdt == torch.bfloat16 else vals.numpy())
    mesh = pm.make_mesh_1d(2, device="cpu")
    rest = pm._place_rest(mesh, (rows, cols, vals_host))
    x, y0 = _x(rng, n, xdt), _x(rng, m, xdt)
    new = pm._add_rest(y0.clone(), rest, x)
    old = y0.clone().index_add_(0, torch.from_numpy(rows),
                                (vals * x[torch.from_numpy(cols)]).to(xdt))
    assert torch.equal(new, old)


def test_fold_plan_layout():
    """Each touched row's segment is its value in y, then its terms in
    stream order."""
    ids = np.array([5, 2, 5, 7, 2, 5])
    rows, gather, lengths = torch_csr.fold_plan(ids, "cpu")
    assert rows.tolist() == [2, 5, 7]
    assert lengths.tolist() == [3, 4, 2]
    # positions: 0..2 the rows' values, 3 + k term k
    assert gather.tolist() == [0, 3 + 1, 3 + 4, 1, 3 + 0, 3 + 2, 3 + 5,
                               2, 3 + 3]


def test_segment_lengths_needs_sorted_ids():
    assert torch_csr.segment_lengths(torch.tensor([0, 0, 2]), 4).tolist() \
        == [2, 0, 1, 0]
    with pytest.raises(ValueError, match="not sorted"):
        torch_csr.segment_lengths(torch.tensor([1, 0]), 2)


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 3 * 128 + 5, 1000, 1024,
                               1025, 3 * 1024 + 5, (1024 ** 2) * 2 + 7])
def test_card_prefix_sum_exact_on_integers(n):
    """The row scan (one row up to ONE_ROW, 1,024; past it rows of
    SCAN_ROW, 128, the carry scanned the same way, to depth 3 at 2M) equals
    cumsum bit for bit where every partial sum is exact."""
    rng = np.random.default_rng(n)
    v = torch.from_numpy(rng.integers(-8, 9, size=n).astype(np.float32))
    got = torch_csr.prefix_sum(v)
    assert got.shape == (n,) and torch.equal(got, torch.cumsum(v, 0))


def test_card_prefix_sum_f64():
    rng = np.random.default_rng(8)
    v = torch.from_numpy(rng.standard_normal(70_001))
    want = torch.cumsum(v, 0)
    err = (torch_csr.prefix_sum(v) - want).abs().max()
    assert float(err) <= 1e-12 * float(want.abs().max())


@pytest.mark.parametrize("method", ["BALANCED", "BALANCED_YID", "BALANCED2"])
def test_scans_with_the_card_prefix_sum(monkeypatch, method):
    """The scan plans through the row prefix sum give their y through
    the old sequential ``torch.cumsum`` within f64 rounding of the
    prefixes."""
    import spmv_tpu_torch as st
    a = generate.power_law(3000, 3000, 60_000, dtype=np.float64, seed=9)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(a.n))
    h = st.create_handle(a, method=getattr(st.Method, method), device="cpu")
    got = st.spmv(h, x)
    monkeypatch.setattr(torch_csr, "prefix_sum",
                        lambda v: torch.cumsum(v, dim=0))
    want = st.spmv(th.create_handle(a, method=getattr(st.Method, method),
                                    device="cpu"), x)
    absx = np.abs(np.asarray(a.vals)).sum() * float(x.abs().max())
    assert float((got - want).abs().max()) <= 1e-12 * absx


def test_no_nonzeros_give_zero_rows():
    """Zero nonzeros: every segment empty, y zero."""
    ids = torch.zeros(0, dtype=torch.int64)
    y = torch_csr.segment_sum_spmv(torch_csr.segment_lengths(ids, 4), ids,
                                   torch.zeros(0), torch.ones(3))
    assert y.tolist() == [0.0] * 4
