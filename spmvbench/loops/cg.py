"""HPCG's CG sets: ``solvers.cg(h, b, tol, maxiter)`` solve after solve.
b cycles through a pool of right-hand sides drawn on the device from the
seed (standard normal, in the configuration's dtype)."""

from __future__ import annotations

import math

import torch

from spmvbench.reference import plain


def make(port, h, a, cfg, traffic, seed, device):
    return CgLoop(port, h, cfg, traffic, seed, device)


class CgLoop:
    def __init__(self, port, h, cfg, traffic, seed, device):
        self.port, self.h = port, h
        self.maxiter, self.tol = traffic["maxiter"], traffic["tol"]
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        self.b = torch.randn(traffic["rhs_pool"], h.n, generator=g,
                             dtype=getattr(torch, cfg["dtype"]),
                             device=device)
        self.i = 0

    def unit(self, wrap):
        k = self.i % self.b.shape[0]
        self.i += 1
        op = self.h
        if wrap is not None:
            h, spmv = self.h, self.port.spmv
            op = wrap(lambda x: spmv(h, x))
        x, res, it = self.port.solvers.cg(op, self.b[k], tol=self.tol,
                                          maxiter=self.maxiter)
        ok = it == self.maxiter and math.isfinite(res)
        # the first product is r = b − A·0
        return self.maxiter + 1, ok, {"k": k, "x": x, "res": res}

    def release(self):
        self.h = None

    def reference(self, ref, item):
        x, res = plain.cg(ref, self.b[item["k"]], self.maxiter)
        return {"x": x, "res": float(res)}

    def gaps(self, out, want):
        return {"x_gap": plain.rel_gap(out["x"], want["x"]),
                "res_gap": abs(out["res"] - want["res"]) / want["res"]}
