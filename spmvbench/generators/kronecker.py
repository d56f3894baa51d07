"""The Graph500 Kronecker generator, as its specification states it
(graph500.org, "Graph 500 Benchmark 1", section 3.4, the reference
``kronecker_generator.m``), turned into PageRank's matrix, on the device.

Edges: for each of SCALE bits, every edge draws two uniforms; its row bit
is 1 where the first exceeds A + B, its column bit is 1 where the second
exceeds C / (1 − (A + B)) after a row bit of 1, else A / (A + B).  Vertex
labels are then permuted.  (The specification's shuffle of the edge list
changes no matrix, so it is left out.)  The graph is made undirected, each
edge both ways, with self-loops and duplicates dropped, as Graph500's
kernels and GAP's ``-s`` option read it.  The matrix is the column-
stochastic transition matrix of that graph: A[v, u] = 1 / outdeg(u) for
each edge u–v, so that PageRank's step is r ← (1 − d) / n + d · A r.
Vertices with no edge keep an empty row and column.

The draws are a ``torch.Generator`` on the run's device seeded with the
run's seed, one call of 2 × M uniforms a bit, and the sort that drops
duplicates runs there too; the CSR arrays come back to the host for
``create_handle``.
"""

from __future__ import annotations

import torch


def edges(scale: int, edgefactor: int, initiator, draw) -> torch.Tensor:
    """The spec's edge list, labels not yet permuted: (2, M) int64.
    ``draw()`` gives the next bit's (2, M) uniforms."""
    a, b, c, _d = initiator
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    ij = None
    for bit in range(scale):
        u = draw()
        ii = u[0] > ab
        jj = u[1] > torch.where(ii, c_norm, a_norm)
        step = torch.stack([ii, jj]).to(torch.int64) << bit
        ij = step if ij is None else ij + step
    return ij


def generate(cfg: dict, seed: int, device="cpu") -> dict:
    scale = cfg["scale"]
    n = 1 << scale
    m = cfg["edgefactor"] << scale
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    ij = edges(scale, cfg["edgefactor"], cfg["initiator"],
               lambda: torch.rand(2, m, generator=g, dtype=torch.float64,
                                  device=device))
    ij = torch.randperm(n, generator=g, device=device)[ij]
    src = torch.cat([ij[0], ij[1]])
    dst = torch.cat([ij[1], ij[0]])
    del ij
    keep = src != dst
    # row dst, column src: one key a nonzero, sorted and unique
    key = torch.unique(dst[keep] * n + src[keep])
    del src, dst, keep
    rows, cols = key // n, key % n
    deg = torch.bincount(rows, minlength=n)   # symmetric: outdeg = indeg
    rowptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(deg, 0, out=rowptr[1:])
    vals = (1.0 / deg[cols].to(torch.float64)).to(getattr(torch,
                                                          cfg["dtype"]))
    return {"m": n, "n": n,
            "rowptr": rowptr.to(torch.int32).cpu().numpy(),
            "colidx": cols.to(torch.int32).cpu().numpy(),
            "vals": vals.cpu().numpy()}
