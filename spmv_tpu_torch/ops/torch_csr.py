"""Plain PyTorch execution plans (the port of ``spmv_tpu/ops/xla_csr.py``).

The JAX package computes these in XLA, not Pallas, so they stay plain
PyTorch here, on the CPU and on the card alike: the Serial plan (AUTO's
pick under 10k nonzeros, ``inspector._decide``), the scans of Balanced,
BalancedYid, Balanced2 and CSR5's fall-through, the chunked SELL-C-σ plan
(``VectorizedWay.NONE``, and the SELL ladder's last rung), the BCSR block
products, and the mesh's shard bodies (the tiled scan of the dist scan
plan and the shifted FMAs of the dist DIA plan, ``parallel/mesh.py``).
The JAX plans' sorted ``segment_sum`` becomes :func:`segment_sum`
(``torch.segment_reduce`` over run lengths counted once, when a plan is
bound), and their prefix sums :func:`prefix_sum`.  Both add in one fixed
order, so a plan gives the same y on every call, on the card as on the
CPU.  On the card ``index_add_`` over repeated indices adds with float
atomics, and a 1-D ``torch.cumsum`` runs a scan whose sums depend on
thread timing.  An ``index_add_`` whose indices are all distinct lands one
add on each row, in stream order, and stays where the glue uses one.

bf16 values upcast to x's type (f32 for a bf16 plan) before the product,
and every sum runs in that type, as ``_acc_dtype`` does in the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import dev_put

__all__ = ["gather_x", "segment_lengths", "segment_sum", "fold_plan",
           "fold_add", "prefix_sum", "prefix_sum_rows", "segment_sum_spmv",
           "scan_spmv_global", "scan_spmv_tiled", "balanced2_spmv",
           "sell_spmv", "dia_spmv", "bcsr_spmv"]

#: the row of the fixed-order prefix sums past ONE_ROW (:func:`prefix_sum`).
#: PyTorch's row scan gives a block 32 rows, so long rows leave most of the
#: card idle; rows of 128 gave the long scans their least device time of
#: 32 to 4,096 on an NVIDIA H100 (``plain_ab.py``: BalancedYid's route, one
#: scan over 2.1M products, 0.071 ms a call at 128, 0.069 at 256, 0.088 at
#: 1,024, 0.436 at 32; Balanced2 least at 128)
SCAN_ROW = 128
#: a prefix sum no longer than this scans as one row, one launch: rows of
#: SCAN_ROW would add a level of small launches to the tiled scans' carries
#: (a few hundred tiles), which cost the 4-shard scan 0.023 ms a call more
#: on the same card
ONE_ROW = 1024


def gather_x(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The hot gather; indices are in bounds by construction."""
    return x[idx]


def _as_x(vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``vals`` in x's type (bf16 values upcast exactly; no copy when the
    types agree)."""
    return vals.to(x.dtype)


def segment_lengths(ids: torch.Tensor, nseg: int) -> torch.Tensor:
    """The run length of each of ``nseg`` segments in ``ids``, the sorted
    segment id of each item, for :func:`segment_sum`.  Counted once, when
    a plan is bound (an integer count, exact on every device).  Raises
    ValueError when ``ids`` is not sorted."""
    if ids.numel() > 1 and not bool((ids[1:] >= ids[:-1]).all()):
        raise ValueError("segment ids are not sorted")
    return torch.bincount(ids, minlength=nseg)


def segment_sum(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Each run of ``data``'s rows (axis 0), ``lengths`` long, summed from
    zero in a fixed order: in stream order on the CPU, which is the order
    ``index_add_`` into zeros follows there, bit for bit; on CUDA a block
    or a thread a segment, never atomics.  ``lengths`` add up to
    ``data.shape[0]`` by construction (:func:`segment_lengths`), so the
    check that would read them back to the host every call is off."""
    return torch.segment_reduce(data, "sum", lengths=lengths, axis=0,
                                unsafe=True)


def fold_plan(ids, device):
    """The placement of ``y[ids[k]] += terms[k]`` with repeated ``ids``
    (:func:`fold_add`): the touched rows, a gather that lays out each
    row's segment as its value in y followed by its terms in stream order,
    and the segments' lengths, as tensors on ``device``."""
    ids = np.asarray(ids, dtype=np.int64)
    order = np.argsort(ids, kind="stable")
    s = ids[order]
    first = np.ones(len(s), dtype=bool)
    first[1:] = s[1:] != s[:-1]
    starts = np.flatnonzero(first)
    k = len(starts)
    # the sorted term i of segment j sits at i + j + 1, after the j + 1
    # row values of the segments up to its own
    slot = starts + np.arange(k)
    gather = np.empty(k + len(ids), dtype=np.int64)
    gather[slot] = np.arange(k)
    rest = np.ones(len(gather), dtype=bool)
    rest[slot] = False
    gather[rest] = k + order
    lengths = np.diff(np.append(starts, len(s))) + 1
    return (dev_put(s[first], device), dev_put(gather, device),
            dev_put(lengths.astype(np.int64), device))


def fold_add(y: torch.Tensor, fold, terms: torch.Tensor) -> torch.Tensor:
    """``y[ids] += terms`` in place, ``ids`` repeating (``fold`` is
    :func:`fold_plan` of them): each touched row's sum starts from its
    value in y and adds its terms in stream order, the order ``index_add_``
    follows on the CPU, bit for bit there; one :func:`segment_sum` and a
    copy to distinct rows, in the same order on every call on the card."""
    rows, gather, lengths = fold
    if not rows.numel():
        return y
    data = torch.cat([y[rows], terms.to(y.dtype)])[gather]
    return y.index_copy_(0, rows, segment_sum(data, lengths))


def prefix_sum_rows(t: torch.Tensor) -> torch.Tensor:
    """``torch.cumsum(t, dim=1)`` of a 2-D ``t``: PyTorch's row scan, one
    fixed order.  A one-row ``t`` would go to the 1-D scan on CUDA
    (:func:`prefix_sum`), so it scans beside a row of zeros, on every
    device."""
    if t.shape[0] == 1:
        return torch.cumsum(torch.cat([t, torch.zeros_like(t)]), dim=1)[:1]
    return torch.cumsum(t, dim=1)


def prefix_sum(v: torch.Tensor) -> torch.Tensor:
    """The inclusive prefix sum of the 1-D ``v``, added in the same order
    on every call and on every device.  On CUDA a 1-D ``torch.cumsum`` is
    a decoupled look-back scan: a tile adds the prefixes its predecessors
    had published when it looked, so its float sums change from call to
    call.  So ``v`` is zero-padded into rows of :data:`SCAN_ROW` (one row
    of n up to :data:`ONE_ROW`; two rows at least), each row scanned
    (PyTorch's row scan, fixed in order), and each row's carry is the
    prefix of the row totals before it, taken the same way.  On the CPU
    the sums agree with ``torch.cumsum``'s sequential ones within rounding,
    not bit for bit."""
    n = v.shape[0]
    row = SCAN_ROW if n > ONE_ROW else max(n, 1)
    nrows = max(-(-n // row), 2)
    t = v.new_empty(nrows, row)
    flat = t.view(-1)
    flat[:n] = v
    flat[n:] = 0
    local = torch.cumsum(t, dim=1)
    if n > row:
        carry = prefix_sum(local[:, -1])
        local[1:] += carry[:-1, None]
    return local.view(-1)[:n]


def segment_sum_spmv(row_lengths, colidx, vals, x) -> torch.Tensor:
    """Method_Serial plan: one gather of x, then each row's products
    summed (:func:`segment_sum` over ``row_lengths``, all m rows), in f64
    for f64 values and in f32 otherwise."""
    dt = torch.float64 if vals.dtype == torch.float64 else torch.float32
    prod = vals.to(dt) * x.to(dt)[colidx]
    return segment_sum(prod, row_lengths)


def scan_spmv_global(colidx_pad, vals_pad, row_start, row_end,
                     x) -> torch.Tensor:
    """Method_BalancedYid plan: one global prefix sum of the product
    stream; row i is ``csum[end_i] - csum[start_i]`` (the stream carries
    one prepended zero).  Its f32 sums carry about eps·sqrt(nnz) absolute
    error, as the JAX plan's do."""
    csum = prefix_sum(_as_x(vals_pad, x) * gather_x(x, colidx_pad))
    return gather_x(csum, row_end) - gather_x(csum, row_start)


def scan_spmv_tiled(colidx_pad, vals_pad, row_start, row_end, x, *,
                    tile: int) -> torch.Tensor:
    """Method_Balanced plan: a prefix sum per tile of the product stream
    plus a carry scan across tiles; row i is ``csum[end_i] -
    csum[start_i]`` (the stream carries one prepended zero), where csum is
    a position's prefix in its tile plus its tile's carry.

    The difference is taken by parts: a row inside one tile is ``local[e]
    - local[s]``; a row from tile ts to tile te adds its first tile's rest
    (``total[ts] - local[s]``) and the carry difference of the tiles in
    between (``carry[te] - carry[ts + 1]``, zero when te = ts + 1).  So a
    short row never meets the carry, whose f32 rounding (eps·|carry|, large
    where a stream's products drift one way, as a web graph's hub columns
    make them) would otherwise land on it; only a row holding whole tiles
    does, and its own sum is that large.  The JAX plan subtracts the two
    prefixes whole; the two agree within f32 rounding."""
    prod = (_as_x(vals_pad, x) * gather_x(x, colidx_pad)).reshape(-1, tile)
    local = prefix_sum_rows(prod)
    total = local[:, -1]
    carry = prefix_sum(total)
    carry = torch.cat([carry.new_zeros(1), carry[:-1]])
    local = local.reshape(-1)
    ts = torch.div(row_start, tile, rounding_mode="floor")
    te = torch.div(row_end, tile, rounding_mode="floor")
    first = torch.where(te > ts, gather_x(total, ts), total.new_zeros(()))
    mid = (gather_x(carry, te)
           - gather_x(carry, torch.minimum(ts + 1, te)))
    return ((first - gather_x(local, row_start))
            + gather_x(local, row_end)) + mid


def balanced2_spmv(colidx_pad, vals_pad, vrow_start, vrow_end, sub_start,
                   sub_end, x, *, tile: int) -> torch.Tensor:
    """Method_Balanced2 plan: the tiled scan over the virtual sub-rows
    (mega-rows cut into runs of at most ``tile`` nonzeros), then a second
    short prefix sum folds each row's run of sub-rows."""
    y_v = scan_spmv_tiled(colidx_pad, vals_pad, vrow_start, vrow_end, x,
                          tile=tile)
    csum2 = torch.cat([y_v.new_zeros(1), prefix_sum(y_v)])
    return gather_x(csum2, sub_end) - gather_x(csum2, sub_start)


def sell_spmv(cols, vals, slice_lengths, inv_pos, x, *,
              identity_order: bool) -> torch.Tensor:
    """Method_SellCSigma / Method_Parallel plan over the flat chunked SELL
    stream (``formats/sell.py``): each (8, 128) chunk's lane partials,
    summed into their 128-row slice (:func:`segment_sum` over the chunks
    of each slice, ``slice_lengths``), then one inverse-permutation gather
    back to row order."""
    part = (_as_x(vals, x) * gather_x(x, cols)).sum(dim=1)  # (nchunks, 128)
    y_all = segment_sum(part, slice_lengths).reshape(-1)
    if identity_order:
        return y_all[:inv_pos.shape[0]]
    return gather_x(y_all, inv_pos)


def bcsr_spmv(blocks, block_row_lengths, block_cols, x, *,
              m: int) -> torch.Tensor:
    """Method_Bcsr plan: each dense 128×128 block times its 128-column
    slice of x, then the block partials summed by block row
    (:func:`segment_sum` over ``block_row_lengths``, all block rows).
    bf16 blocks multiply into f32, f32 blocks sum in f32, f64 in f64.  The
    products are elementwise multiplies and a sum, never a matmul, so
    TensorFloat-32 (its 10-bit mantissa fails the f32 bound), however the
    caller has set it, cannot reach them."""
    acc = torch.float64 if blocks.dtype == torch.float64 else torch.float32
    bs = blocks.shape[-1]
    n_pad = -(-x.shape[0] // bs) * bs
    xp = torch.cat([x.to(acc), x.new_zeros(n_pad - x.shape[0], dtype=acc)])
    xb = xp.view(-1, bs)[block_cols]                     # (nb, 128)
    partial = torch.mul(blocks, xb[:, None, :]).sum(dim=2, dtype=acc)
    return segment_sum(partial, block_row_lengths).reshape(-1)[:m]


def dia_spmv(data, x, offsets, m: int, row0: int = 0,
             pad_l: int = 0) -> torch.Tensor:
    """Banded SpMV as shifted FMAs: ``y[i] = Σ_d data[d, i] · x[pad_l + o_d
    + row0 + i]`` over ``m`` rows, ``x`` zero-padded by the caller so every
    slice is in range; bf16 or f32 diagonals multiply in x's type."""
    acc = torch.zeros(m, dtype=x.dtype, device=x.device)
    for k, o in enumerate(offsets):
        s = pad_l + o + row0
        acc = acc + _as_x(data[k], x) * x[s:s + m]
    return acc
