"""Plain PyTorch statements of the products and loops the cells time.

The reference computes in f64.  The control that shows a limit can fail
is the same code one precision down (``LOWER``): f32 for an f64
configuration, and for an f32 one bf16 storage of the values and of every
vector, each product accumulated in f32 and rounded back to bf16.
"""

from __future__ import annotations

import torch

#: the precision a configuration states → the control's, the next below
LOWER = {torch.float64: torch.float32, torch.float32: torch.bfloat16}


class Csr:
    """y = A x as a gather, a multiply and a scatter-add over the CSR
    arrays, in ``dtype``, on ``device``."""

    def __init__(self, a: dict, dtype: torch.dtype, device):
        rowptr = torch.as_tensor(a["rowptr"]).to(device, torch.int64)
        self.m = int(a["m"])
        self.rows = torch.repeat_interleave(
            torch.arange(self.m, device=device), rowptr.diff())
        self.cols = torch.as_tensor(a["colidx"]).to(device, torch.int64)
        self.dtype = dtype
        self.acc = torch.float32 if dtype == torch.bfloat16 else dtype
        self.vals = torch.as_tensor(a["vals"]).to(device).to(dtype) \
            .to(self.acc)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).to(self.acc)
        y = torch.zeros(self.m, dtype=self.acc, device=x.device)
        y.index_add_(0, self.rows, self.vals * x[self.cols])
        return y.to(self.dtype)


def cg(a: Csr, b: torch.Tensor, iters: int):
    """``iters`` CG iterations from x = 0 at tolerance 0: (x, ‖r‖) of the
    recurrence, as HPCG's CG and ``solvers.cg`` state it; a residual of
    exactly 0 ends the loop."""
    b = b.to(a.dtype)
    x = torch.zeros_like(b)
    r = b - a(x)
    p = r
    rs = torch.dot(r, r)
    for _ in range(iters):
        if not float(rs) > 0:
            break
        ap = a(p)
        alpha = rs / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
    return x, rs.sqrt()


def pagerank(a: Csr, r0: torch.Tensor, damping: float, iters: int):
    """GAP's PageRank step ``iters`` times from r0: r ← (1 − d)/n + d A r."""
    r = r0.to(a.dtype)
    base = (1.0 - damping) / r.numel()
    for _ in range(iters):
        r = (a(r) * damping + base).to(a.dtype)
    return r


def chain(a: Csr, x: torch.Tensor, k: int):
    """``k`` products, each y divided by the power of two at or below
    max|y|."""
    x = x.to(a.dtype)
    for _ in range(k):
        y = a(x)
        top = y.abs().max().to(torch.float64).clamp_min(1e-30)
        x = y / torch.exp2(torch.floor(torch.log2(top))).to(y.dtype)
    return x


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| / max |want|, in f64."""
    got, want = got.to(torch.float64), want.to(torch.float64)
    return float((got - want).abs().max() / want.abs().max())


def direction_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """:func:`rel_gap` of the two vectors, each divided by its own
    max |·| first: a chain's scale is a power of two that either side
    may pick one step apart when max|y| lies at a power of two."""
    got, want = got.to(torch.float64), want.to(torch.float64)
    return rel_gap(got / got.abs().max(), want / want.abs().max())
