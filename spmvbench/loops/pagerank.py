"""GAP's PageRank: solves of a fixed number of iterations, each
r ← (1 − d)/n + d · A r on the port's ``spmv(h, r)``, with GAP's teleport
(1 − d)/n and no redistribution of dangling mass.  Each solve starts from
its own r0, uniform draws on the device from the seed normalised to sum
1, and has one host read at its end: the L1 change of its last
iteration, which GAP tests against its tolerance."""

from __future__ import annotations

import math

import torch

from spmvbench.reference import plain


def make(port, h, a, cfg, traffic, seed, device):
    return PageRankLoop(port, h, cfg, traffic, seed, device)


class PageRankLoop:
    def __init__(self, port, h, cfg, traffic, seed, device):
        self.port, self.h = port, h
        self.d, self.iters = traffic["damping"], traffic["iterations"]
        self.dtype = getattr(torch, cfg["dtype"])
        self.g = torch.Generator(device=device)
        self.g.manual_seed(seed)
        self.device = device

    def unit(self, wrap):
        h, spmv = self.h, self.port.spmv
        op = (lambda x: spmv(h, x)) if wrap is None \
            else wrap(lambda x: spmv(h, x))
        r0 = torch.rand(h.n, generator=self.g, dtype=self.dtype,
                        device=self.device)
        r0 /= r0.sum()
        base = (1.0 - self.d) / h.n
        r = prev = r0
        for _ in range(self.iters):
            prev, r = r, op(r).mul(self.d).add_(base)
        change = (r - prev).abs_().sum().item()
        return self.iters, math.isfinite(change), {"r0": r0, "r": r}

    def release(self):
        self.h = None

    def reference(self, ref, item):
        return {"r": plain.pagerank(ref, item["r0"], self.d, self.iters)}

    def gaps(self, out, want):
        return {"r_gap": plain.rel_gap(out["r"], want["r"])}
