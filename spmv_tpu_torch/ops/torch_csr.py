"""Plain PyTorch execution plans (the port of ``spmv_tpu/ops/xla_csr.py``).

The JAX package computes these in XLA, not Pallas, so they stay plain
PyTorch here, on the CPU and on the card alike: the Serial plan (AUTO's
pick under 10k nonzeros, ``inspector._decide``), the scans of Balanced,
BalancedYid, Balanced2 and CSR5's fall-through, the chunked SELL-C-σ plan
(``VectorizedWay.NONE``, and the SELL ladder's last rung), the BCSR block
products, and the mesh's shard bodies (the tiled scan of the dist scan
plan and the shifted FMAs of the dist DIA plan, ``parallel/mesh.py``).
The JAX plans' sorted ``segment_sum`` becomes ``index_add_``.

bf16 values upcast to x's type (f32 for a bf16 plan) before the product,
and every sum runs in that type, as ``_acc_dtype`` does in the JAX
package.
"""

from __future__ import annotations

import torch

__all__ = ["gather_x", "segment_sum_spmv", "scan_spmv_global",
           "scan_spmv_tiled", "balanced2_spmv", "sell_spmv", "dia_spmv",
           "bcsr_spmv"]


def gather_x(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The hot gather; indices are in bounds by construction."""
    return x[idx]


def _as_x(vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``vals`` in x's type (bf16 values upcast exactly; no copy when the
    types agree)."""
    return vals.to(x.dtype)


def segment_sum_spmv(rows, colidx, vals, x, *, m: int) -> torch.Tensor:
    """Method_Serial plan: one gather of x, then a scatter-add by row, in
    f64 for f64 values and in f32 otherwise."""
    dt = torch.float64 if vals.dtype == torch.float64 else torch.float32
    prod = vals.to(dt) * x.to(dt)[colidx]
    return torch.zeros(m, dtype=dt, device=x.device).index_add_(0, rows,
                                                                prod)


def scan_spmv_global(colidx_pad, vals_pad, row_start, row_end,
                     x) -> torch.Tensor:
    """Method_BalancedYid plan: one global prefix sum of the product
    stream; row i is ``csum[end_i] - csum[start_i]`` (the stream carries
    one prepended zero).  Its f32 sums carry about eps·sqrt(nnz) absolute
    error, as the JAX plan's do."""
    csum = torch.cumsum(_as_x(vals_pad, x) * gather_x(x, colidx_pad),
                        dim=0)
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
    local = torch.cumsum(prod, dim=1)
    total = local[:, -1]
    carry = torch.cumsum(total, dim=0)
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
    csum2 = torch.cat([y_v.new_zeros(1), torch.cumsum(y_v, dim=0)])
    return gather_x(csum2, sub_end) - gather_x(csum2, sub_start)


def sell_spmv(cols, vals, chunk_ids, inv_pos, x, *, nslices: int,
              identity_order: bool) -> torch.Tensor:
    """Method_SellCSigma / Method_Parallel plan over the flat chunked SELL
    stream (``formats/sell.py``): each (8, 128) chunk's lane partials,
    added into their 128-row slice by ``index_add_``, then one
    inverse-permutation gather back to row order."""
    part = (_as_x(vals, x) * gather_x(x, cols)).sum(dim=1)  # (nchunks, 128)
    y_all = torch.zeros(nslices, part.shape[1], dtype=part.dtype,
                        device=x.device).index_add_(0, chunk_ids,
                                                    part).reshape(-1)
    if identity_order:
        return y_all[:inv_pos.shape[0]]
    return gather_x(y_all, inv_pos)


def bcsr_spmv(blocks, block_rows, block_cols, x, *, m: int,
              nblock_rows: int) -> torch.Tensor:
    """Method_Bcsr plan: each dense 128×128 block times its 128-column
    slice of x, then ``index_add_`` of the block partials by block row.
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
    y2 = torch.zeros(nblock_rows, bs, dtype=acc,
                     device=x.device).index_add_(0, block_rows, partial)
    return y2.reshape(-1)[:m]


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
