"""Synthetic test-matrix generators (a copy of ``spmv_tpu/io/generate.py``:
the same calls with the same seeds give the same matrices).

The reference synthesizes its bench inputs as ``Val[i] = rand()%8 * 0.125`` and
``X[i] = 1`` (src/samples/test_spmv.c:199-202) — dyadic-rational values that
make float32/float64 arithmetic *exact* for modest row sums, so validation can
use exact comparison.  :func:`exact_values` reproduces that trick as a fixture.

Generators cover the structural regimes the reference's methods exist to
handle: banded (uniform rows — serial/parallel), power-law (mega-rows —
balanced2/Yid), uniform random (SELL/CSR5), plus empty-row and rectangular
cases called out in SURVEY.md §7 as property-test musts.
"""

from __future__ import annotations

import numpy as np

from ..types import CsrMatrix, INT_DTYPE

__all__ = [
    "exact_values",
    "banded",
    "random_uniform",
    "power_law",
    "webbase_like",
    "diag_plus_random",
    "with_empty_rows",
    "make_x",
]


def exact_values(rng: np.random.Generator, nnz: int, dtype=np.float64) -> np.ndarray:
    """Dyadic-exact values (k/8, k in 0..7) — reference test_spmv.c:200."""
    return (rng.integers(0, 8, size=nnz).astype(np.float64) * 0.125).astype(dtype)


def make_x(n: int, dtype=np.float64, kind: str = "ones",
           seed: int = 0) -> np.ndarray:
    """x vector fixtures: reference uses all-ones (test_spmv.c:202)."""
    if kind == "ones":
        return np.ones(n, dtype=dtype)
    rng = np.random.default_rng(seed)
    if kind == "exact":
        return exact_values(rng, n, dtype)
    return rng.standard_normal(n).astype(dtype)


def banded(m: int, n: int, bandwidth: int, dtype=np.float64,
           seed: int = 0, exact: bool = True) -> CsrMatrix:
    """Dense-banded matrix (BASELINE.json config 1)."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for off in range(-bandwidth, bandwidth + 1):
        r = np.arange(max(0, -off), min(m, n - off), dtype=INT_DTYPE)
        rows.append(r)
        cols.append(r + off)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = exact_values(rng, rows.size, dtype) if exact else \
        rng.standard_normal(rows.size).astype(dtype)
    return CsrMatrix.from_coo(m, n, rows, cols, vals, sum_duplicates=False)


def random_uniform(m: int, n: int, nnz_per_row: int, dtype=np.float64,
                   seed: int = 0, exact: bool = True) -> CsrMatrix:
    """Uniform random sparsity: every row ~nnz_per_row nonzeros."""
    rng = np.random.default_rng(seed)
    counts = rng.poisson(nnz_per_row, size=m).clip(0, n)
    rows = np.repeat(np.arange(m, dtype=INT_DTYPE), counts)
    cols = rng.integers(0, n, size=rows.size).astype(INT_DTYPE)
    vals = exact_values(rng, rows.size, dtype) if exact else \
        rng.standard_normal(rows.size).astype(dtype)
    return CsrMatrix.from_coo(m, n, rows, cols, vals)  # duplicates summed


def power_law(m: int, n: int, nnz_target: int, alpha: float = 1.8,
              dtype=np.float64, seed: int = 0, exact: bool = True) -> CsrMatrix:
    """Power-law row-length distribution — a few mega-rows, many tiny rows.

    This is the regime the reference's balanced2/balancedYid splitters exist
    for (parallel_balanced2_spmv.c:55-209) and BASELINE.json config 3's
    webbase-1M stands in for.
    """
    rng = np.random.default_rng(seed)
    raw = rng.zipf(alpha, size=m).astype(np.float64)
    counts = np.minimum((raw / raw.sum() * nnz_target).astype(np.int64), n)
    rows = np.repeat(np.arange(m, dtype=INT_DTYPE), counts)
    cols = rng.integers(0, n, size=rows.size).astype(INT_DTYPE)
    vals = exact_values(rng, rows.size, dtype) if exact else \
        rng.standard_normal(rows.size).astype(dtype)
    return CsrMatrix.from_coo(m, n, rows, cols, vals)


def webbase_like(m: int, n: int, nnz_target: int, alpha: float = 2.2,
                 local_frac: float = 0.8, spread: int = 2048,
                 dtype=np.float64, seed: int = 0,
                 exact: bool = True) -> CsrMatrix:
    """Web-graph-shaped ultra-sparse matrix (BASELINE.json config 3's
    webbase-1M stand-in; this environment has no network egress to fetch
    the real SuiteSparse file — see COMPARISON.md).

    Mimics the structure a crawl-ordered link matrix actually has, unlike
    a uniform-random ultra-sparse synthetic (which is adversarially
    structureless — PERFNOTES.md "webbase-shaped" note):

    * power-law out-degrees, gamma ≈ ``alpha`` (a few hub rows, a long
      tail of 1-3 link pages);
    * ``local_frac`` of links point near the diagonal (pages link within
      their crawl neighborhood / domain, ±``spread``);
    * the rest point at power-law-popular hub columns (Zipf over a fixed
      random permutation of column ids — popular pages are arbitrary ids,
      not low ids).
    """
    rng = np.random.default_rng(seed)
    raw = rng.zipf(alpha, size=m).astype(np.float64)
    counts = np.minimum((raw / raw.sum() * nnz_target).astype(np.int64), n)
    counts = np.maximum(counts, 1)          # every page links somewhere
    rows = np.repeat(np.arange(m, dtype=np.int64), counts)
    k = rows.size
    is_local = rng.random(k) < local_frac
    center = (rows * n) // max(m, 1)
    local_cols = np.clip(
        center + rng.integers(-spread, spread + 1, size=k), 0, n - 1)
    # hub columns: Zipf ranks mapped through a random permutation so
    # popularity is uncorrelated with column position
    ranks = np.minimum(rng.zipf(1.5, size=k), n) - 1
    hub_perm = rng.permutation(n)
    hub_cols = hub_perm[ranks]
    cols = np.where(is_local, local_cols, hub_cols)
    vals = exact_values(rng, k, dtype) if exact else \
        rng.standard_normal(k).astype(dtype)
    return CsrMatrix.from_coo(m, n, rows.astype(INT_DTYPE),
                              cols.astype(INT_DTYPE), vals)


def diag_plus_random(m: int, nnz_per_row: int = 8, dtype=np.float64,
                     seed: int = 0) -> CsrMatrix:
    """SPD-ish square matrix with guaranteed nonzero diagonal (for solvers)."""
    a = random_uniform(m, m, nnz_per_row, dtype=dtype, seed=seed, exact=False)
    d_rows = np.arange(m, dtype=INT_DTYPE)
    rows = np.concatenate([np.repeat(np.arange(m, dtype=INT_DTYPE), a.row_lengths), d_rows])
    cols = np.concatenate([a.colidx, d_rows])
    vals = np.concatenate([a.vals * 0.1, np.full(m, nnz_per_row + 1.0, dtype=dtype)])
    return CsrMatrix.from_coo(m, m, rows, cols, vals)


def with_empty_rows(base: CsrMatrix, empty_fraction: float = 0.3,
                    seed: int = 0) -> CsrMatrix:
    """Zero out a random fraction of rows (CSR5 dirty-bit regime,
    format_avx2.h:44-55)."""
    rng = np.random.default_rng(seed)
    keep = rng.random(base.m) >= empty_fraction
    lengths = base.row_lengths * keep
    rowptr = np.zeros(base.m + 1, dtype=np.int64)
    np.cumsum(lengths, out=rowptr[1:])
    mask = np.repeat(keep, base.row_lengths)
    return CsrMatrix(base.m, base.n, rowptr.astype(INT_DTYPE),
                     base.colidx[mask], base.vals[mask])


def clustered(m: int, n: int, nnz_per_row: int = 32, spread: int = 512,
              dtype=np.float64, seed: int = 0, exact: bool = True) -> CsrMatrix:
    """Locality-rich random matrix: row i's columns within ±spread of the
    diagonal position — the regime the Pallas windowed kernel (SELL-8W) and
    the reorder layer target (cols cluster into few 1024-wide x-windows)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m, dtype=np.int64),
                     rng.poisson(nnz_per_row, size=m).clip(0, 2 * spread))
    center = (rows * n) // max(m, 1)
    cols = center + rng.integers(-spread, spread + 1, size=rows.size)
    cols = np.clip(cols, 0, n - 1)
    vals = exact_values(rng, rows.size, dtype) if exact else \
        rng.standard_normal(rows.size).astype(dtype)
    return CsrMatrix.from_coo(m, n, rows.astype(INT_DTYPE),
                              cols.astype(INT_DTYPE), vals)


def block_random(nblk_rows: int, nblk_cols: int, blocks_per_row: int = 4,
                 block: int = 128, fill: float = 0.5, dtype=np.float64,
                 seed: int = 0) -> CsrMatrix:
    """Block-structured random matrix: dense-ish 128x128 blocks — the BCSR/
    MXU regime (multiphysics/FEM-style coupling patterns)."""
    rng = np.random.default_rng(seed)
    rows_l, cols_l = [], []
    for br in range(nblk_rows):
        bcs = rng.choice(nblk_cols, size=min(blocks_per_row, nblk_cols),
                         replace=False)
        for bc in bcs:
            k = rng.binomial(block * block, fill)
            r = rng.integers(0, block, size=k)
            c = rng.integers(0, block, size=k)
            rows_l.append(br * block + r)
            cols_l.append(bc * block + c)
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = exact_values(rng, rows.size, dtype)
    return CsrMatrix.from_coo(nblk_rows * block, nblk_cols * block,
                              rows.astype(INT_DTYPE), cols.astype(INT_DTYPE),
                              vals)
