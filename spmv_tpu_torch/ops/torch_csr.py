"""Plain PyTorch execution plans (the port of ``spmv_tpu/ops/xla_csr.py``).

The JAX package computes these in XLA, not Pallas, so they stay plain
PyTorch here: the Serial plan (AUTO's pick under 10k nonzeros,
``inspector._decide``), and the mesh's shard bodies, the tiled scan of the
dist scan plan and the shifted FMAs of the dist DIA plan
(``parallel/mesh.py``).
"""

from __future__ import annotations

import torch

__all__ = ["gather_x", "segment_sum_spmv", "scan_spmv_tiled", "dia_spmv"]


def gather_x(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The hot gather; indices are in bounds by construction."""
    return x[idx]


def segment_sum_spmv(rows, colidx, vals, x, *, m: int) -> torch.Tensor:
    """Method_Serial plan: one gather of x, then a scatter-add by row, in
    f64 for f64 values and in f32 otherwise."""
    dt = torch.float64 if vals.dtype == torch.float64 else torch.float32
    prod = vals.to(dt) * x.to(dt)[colidx]
    return torch.zeros(m, dtype=dt, device=x.device).index_add_(0, rows,
                                                                prod)


def scan_spmv_tiled(colidx_pad, vals_pad, row_start, row_end, x, *,
                    tile: int) -> torch.Tensor:
    """Method_Balanced plan: a prefix sum per tile of the product stream
    plus a carry scan across tiles; row i is ``csum[end_i] -
    csum[start_i]`` (the stream carries one prepended zero).  Its f32 sums
    carry about eps·sqrt(nnz) absolute error, as the JAX plan's do."""
    prod = (vals_pad * gather_x(x, colidx_pad)).reshape(-1, tile)
    local = torch.cumsum(prod, dim=1)
    carry = torch.cumsum(local[:, -1], dim=0)
    carry = torch.cat([carry.new_zeros(1), carry[:-1]])
    csum = (local + carry[:, None]).reshape(-1)
    return gather_x(csum, row_end) - gather_x(csum, row_start)


def dia_spmv(data, x, offsets, m: int, row0: int = 0,
             pad_l: int = 0) -> torch.Tensor:
    """Banded SpMV as shifted FMAs: ``y[i] = Σ_d data[d, i] · x[pad_l + o_d
    + row0 + i]`` over ``m`` rows, ``x`` zero-padded by the caller so every
    slice is in range; bf16 or f32 diagonals multiply in x's type."""
    acc = torch.zeros(m, dtype=x.dtype, device=x.device)
    for k, o in enumerate(offsets):
        s = pad_l + o + row0
        acc = acc + data[k].to(x.dtype) * x[s:s + m]
    return acc
