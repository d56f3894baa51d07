"""Dependent products x ← A x / 2^⌊log₂ max|A x|⌋ with one host read a
block.  The power-of-two renorm is a frozen copy of
``spmv_tpu_torch/bench/timing.py:29-119`` (``_EXP_MASK``, ``_pow2_floor``,
``_renorm``): exact, four launches.  The start vector is drawn on the
device from the seed (standard normal, the configuration's dtype); the
chain runs on through the window, block after block.  The host reads a
block's scale ``read_lag`` blocks after it dispatched it, so that the card
has that many blocks queued while the host stands still; ``drain()``
reads the rest and waits for the card."""

from __future__ import annotations

import math
from collections import deque

import torch

from spmvbench.reference import plain

#: the exponent bits of an IEEE float, by its integer view's type
_EXP_MASK = {torch.float32: (torch.int32, 0x7F800000),
             torch.float64: (torch.int64, 0x7FF0000000000000)}


def pow2_floor(y: torch.Tensor) -> torch.Tensor:
    """The largest power of two ≤ max(max|y|, 1e-30), as a 0-dim tensor."""
    itype, mask = _EXP_MASK[y.dtype]
    top = torch.linalg.vector_norm(y, float("inf")).clamp_min(1e-30)
    return (top.view(itype) & mask).view(y.dtype)


def make(port, h, a, cfg, traffic, seed, device):
    return ChainLoop(port, h, cfg, traffic, seed, device)


class ChainLoop:
    def __init__(self, port, h, cfg, traffic, seed, device):
        self.port, self.h = port, h
        self.block, self.lag = traffic["block"], traffic["read_lag"]
        self.pending = deque()
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        self.x = torch.randn(h.n, generator=g,
                             dtype=getattr(torch, cfg["dtype"]),
                             device=device)

    def unit(self, wrap):
        h, spmv = self.h, self.port.spmv
        op = (lambda v: spmv(h, v)) if wrap is None \
            else wrap(lambda v: spmv(h, v))
        x0 = x = self.x
        for _ in range(self.block):
            y = op(x)
            s = pow2_floor(y)
            x = y / s
        self.x = x
        self.pending.append(s)
        ok = True
        while len(self.pending) > self.lag:
            ok &= self._read()
        return self.block, ok, {"x0": x0, "x": x}

    def _read(self) -> bool:
        scale = self.pending.popleft().item()
        return math.isfinite(scale) and scale > 0

    def drain(self) -> bool:
        ok = True
        while self.pending:
            ok &= self._read()
        if self.x.is_cuda:
            torch.cuda.synchronize(self.x.device)
        return ok

    def release(self):
        self.h = None

    def reference(self, ref, item):
        return {"x": plain.chain(ref, item["x0"], self.block)}

    def gaps(self, out, want):
        return {"x_gap": plain.direction_gap(out["x"], want["x"])}
