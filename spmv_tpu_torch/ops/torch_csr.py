"""Plain PyTorch execution plans (the port of ``spmv_tpu/ops/xla_csr.py``).

Only the Serial plan is ported so far: AUTO picks it for matrices under
10k nonzeros (``inspector._decide``).  The JAX package computes it in XLA,
not Pallas, so it stays plain PyTorch here.
"""

from __future__ import annotations

import torch

__all__ = ["segment_sum_spmv"]


def segment_sum_spmv(rows, colidx, vals, x, *, m: int) -> torch.Tensor:
    """Method_Serial plan: one gather of x, then a scatter-add by row."""
    prod = vals.to(torch.float32) * x.to(torch.float32)[colidx]
    return torch.zeros(m, dtype=torch.float32,
                       device=x.device).index_add_(0, rows, prod)
