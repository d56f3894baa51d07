"""HPCG's reference problem: the 27-point stencil of ``GenerateProblem_ref``
on an nx × ny × nz grid, 26 on the diagonal and -1 for each neighbour.

A frozen copy of ``chip_smoke.py:2233-2257`` (``hpcg_matrix``), so that a
later change to the port's tools cannot move the yardstick; it takes the
three sizes from the configuration.  The matrix does not depend on the
seed: HPCG's problem is fixed by its grid.  It is made on the host, where
``device`` plays no part.
"""

from __future__ import annotations

import numpy as np


def generate(cfg: dict, seed: int, device="cpu") -> dict:
    nx, ny, nz = cfg["nx"], cfg["ny"], cfg["nz"]
    n = nx * ny * nz
    i = np.arange(n, dtype=np.int64)
    z, y, x = i // (nx * ny), (i // nx) % ny, i % nx
    cols = np.empty((n, 27), np.int64)
    ok = np.empty((n, 27), bool)
    k = 0
    # offsets in ascending order, so each row's columns ascend
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                cols[:, k] = i + (dz * ny + dy) * nx + dx
                ok[:, k] = ((z + dz >= 0) & (z + dz < nz) & (y + dy >= 0)
                            & (y + dy < ny) & (x + dx >= 0) & (x + dx < nx))
                k += 1
    lengths = ok.sum(1)
    rowptr = np.zeros(n + 1, np.int64)
    np.cumsum(lengths, out=rowptr[1:])
    colidx = cols[ok]
    vals = np.where(colidx == np.repeat(i, lengths), 26.0, -1.0)
    return {"m": n, "n": n, "rowptr": rowptr.astype(np.int32),
            "colidx": colidx.astype(np.int32),
            "vals": vals.astype(cfg["dtype"])}
