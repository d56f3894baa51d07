"""Matrix inspector: features, the AUTO method choice and the tuner.

A jax-free copy of ``spmv_tpu/inspector.py``: ``featurize``,
``choose_method`` and their helpers unchanged, so AUTO routes the same way
in both packages (pinned by ``tests/test_torch_formats.py``), and ``tune``,
which times each candidate on the device it is given and caches the winner
apart from the JAX package's (``tests/test_torch_tune.py``).  The gates
still price plans with the constants measured on the TPU; retuning them for
the H100 is later work.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .types import CsrMatrix, Method

__all__ = ["MatrixFeatures", "featurize", "choose_method", "tune"]


@dataclasses.dataclass(frozen=True)
class MatrixFeatures:
    m: int
    n: int
    nnz: int
    mean_row: float
    std_row: float
    max_row: int
    empty_frac: float
    # Padding overhead if packed as chunked SELL-C-σ (C=128, depth mult-of-8):
    sell_pad_ratio: float
    # Diagonal structure: distinct (col-row) offsets and nnz/(ndiags·m) fill
    ndiags: int = 0
    dia_fill: float = 0.0
    # Block structure: nonempty 128x128 blocks and their mean fill
    nblocks: int = 0
    block_fill: float = 0.0
    # COO2 pass-2 lower bound: (slice,window) pairs · 1024 / nnz
    coo2_pad: float = float("inf")
    # Window locality: estimated SELL-8W padding (tiles·1024/nnz) — the
    # decision metric for the Pallas windowed kernel (PERFNOTES.md).
    # When the coarse pairs floor alone exceeds every decision threshold
    # (> 32), this holds that LOWER BOUND instead of the (multi-second at
    # 32M nnz) exact estimate; coo2_pad inherits the same bound.
    sell8w_pad: float = float("inf")

    @property
    def cv_row(self) -> float:
        return self.std_row / self.mean_row if self.mean_row > 0 else 0.0


def _sell_pad_ratio(lengths: np.ndarray, c: int = 128,
                    sigma: int = 32 * 128, sub: int = 8) -> float:
    """Estimate padded_nnz / nnz for chunked SELL packing without building it."""
    m_pad = max(-(-len(lengths) // c) * c, c)
    lens = np.zeros(m_pad, dtype=np.int64)
    lens[: len(lengths)] = lengths
    grid = -(-m_pad // sigma) * sigma
    lw = np.full(grid, 0, dtype=np.int64)
    lw[:m_pad] = lens
    win = np.sort(lw.reshape(-1, sigma), axis=1)[:, ::-1].reshape(-1)[:m_pad]
    depth = win.reshape(-1, c).max(axis=1)
    padded = np.maximum(-(-depth // sub) * sub, sub)
    total = int((padded * c).sum())
    nnz = int(lens.sum())
    return total / max(nnz, 1)


def _pairs_floor_pad(a: CsrMatrix) -> float:
    """Coarse (1024-row slice, 8-window bundle) pairs-floor pad.

    One O(nnz) bincount that lower-bounds EVERY windowed format's pad
    (finer grids only split pairs) — the pre-gate that keeps the
    multi-second tile estimators off hopeless ultra-sparse matrices
    (PERFNOTES.md "pairs-floor pre-gate").  Returns 0.0 when the coarse
    table itself would be too large to materialize."""
    from .formats.sell8w import WINDOW
    ns8d = max(-(-a.m // 1024), 1)
    nb8d = max(-(-a.n // (1024 * 8)), 1)
    if ns8d * nb8d > (1 << 28):
        return 0.0
    rows_g = np.repeat(np.arange(a.m, dtype=np.int64), a.row_lengths)
    key_g = (rows_g >> 10) * nb8d + (a.colidx.astype(np.int64) >> 13)
    pairs_lb = int(np.count_nonzero(
        np.bincount(key_g, minlength=ns8d * nb8d)))
    return pairs_lb * WINDOW / a.nnz


def featurize(a: CsrMatrix) -> MatrixFeatures:
    from .formats.dia import dia_profile
    lengths = a.row_lengths.astype(np.int64)
    mean = float(lengths.mean()) if a.m else 0.0
    from .formats.bcsr import bcsr_profile
    ndiags, dia_fill = dia_profile(a) if a.nnz else (0, 0.0)
    nblocks, block_fill = bcsr_profile(a) if a.nnz else (0, 0.0)
    if a.nnz:
        from .formats.sell8w import (estimate_sell8w_tiles, WINDOW,
                                     pairs_lower_bound, split_megarows)
        # Pairs-floor pre-gate (the same O(nnz) bincount the handle's AUTO
        # route uses): the coarse (1024-row slice, 8-window bundle) pair
        # count lower-bounds EVERY windowed format — when even that floor
        # exceeds all pad allowances, publish the floor as the bound and
        # skip the estimator cascade (measured 188 s of estimates on
        # uniform 4M×4M d=8 before the inevitable XLA fallback;
        # VERDICT round-3 item 8).
        floor_pad = _pairs_floor_pad(a)
        if floor_pad > 32.0:
            # 32 is featurize's largest sell8w_pad decision threshold
            # (_decide) — past it the exact estimate cannot change any
            # routing, so publish the floor as the bound
            sell8w_pad = floor_pad       # lower BOUND, not an estimate
            coo2_pad = floor_pad
        else:
            # estimate what the plan will actually pack: the handle's
            # SELL-8W route virtually splits mega-rows when that improves
            # the pack (powerlaw100k natural 111 vs split 69) — take the
            # min
            est = estimate_sell8w_tiles(a)
            a_split, subs = split_megarows(a)
            if subs is not None:
                est = min(est, estimate_sell8w_tiles(a_split))
            sell8w_pad = est * WINDOW / a.nnz
            pairs = pairs_lower_bound(a)
            coo2_pad = pairs * WINDOW / a.nnz if pairs else float("inf")
    else:
        sell8w_pad = 1.0
        coo2_pad = 1.0
    return MatrixFeatures(
        m=a.m, n=a.n, nnz=a.nnz,
        mean_row=mean,
        std_row=float(lengths.std()) if a.m else 0.0,
        max_row=int(lengths.max()) if a.m else 0,
        empty_frac=float((lengths == 0).mean()) if a.m else 0.0,
        sell_pad_ratio=_sell_pad_ratio(lengths) if a.m else 1.0,
        ndiags=ndiags, dia_fill=dia_fill, sell8w_pad=sell8w_pad,
        nblocks=nblocks, block_fill=block_fill, coo2_pad=coo2_pad,
    )


def _decide(f) -> Method:
    """The method-selection gates over a feature getter ``f(name)``.

    Gates are ordered cheapest-feature-first so the staged path in
    :func:`choose_method` can stop computing features at the first hit.
    """
    if f("nnz") == 0 or f("m") == 0:
        return Method.SERIAL
    # Banded/diagonal structure → the zero-gather streaming plan (the only
    # SpMV this device runs at full bandwidth, PERFNOTES.md).  Fill gate:
    # streamed zeros must not exceed ~3× the nnz, and the unrolled
    # per-diagonal op count must stay compile-friendly.
    ndiags = f("ndiags")
    if ndiags and ndiags <= 256 and f("dia_fill") >= 0.3:
        return Method.DIA
    # Dense 128x128 block structure → MXU batched matmuls (the only plan
    # whose irregular ops scale as nnz/16384 instead of nnz).
    if f("block_fill") >= 0.15:
        return Method.BCSR
    # Tiny matrices: compile-simple serial plan is fine.
    if f("nnz") < 10_000:
        return Method.SERIAL
    # Window locality good enough for the Pallas windowed kernel (the
    # handle routes SELL_C_SIGMA+VPU there, handle.py) — the dominant
    # winner on this hardware whenever padding is bounded.
    if f("sell8w_pad") <= 3.0:
        return Method.SELL_C_SIGMA
    # Moderate column scatter: the two-pass COO2 path (CSR5's TPU analog).
    if f("coo2_pad") <= 6.0:
        return Method.CSR5
    # High-pad direct SELL-8W: with x resident in VMEM (n <= V2_MAX_N) the
    # grouped v2 kernel pays only the meta/value streams and a tile cost,
    # so even pad ~20 beat the XLA gather floor by >10x on the TPU (the
    # JAX package's measurement, uniform100k).  Memory cap keeps the padded tile stream
    # under ~4 GB (mirrors handle._sell8w_plan's allowance).
    if (f("n") <= 2_000_000
            and f("sell8w_pad") <= min(32.0, 6.7e8 / max(f("nnz"), 1))):
        return Method.SELL_C_SIGMA
    # Past VMEM residency the windowed-DMA kernels serve any n, but each
    # tile pays a ~4 KB x-window DMA — only worth it at modest padding.
    if f("sell8w_pad") <= min(8.0, 6.7e8 / max(f("nnz"), 1)):
        return Method.SELL_C_SIGMA
    if f("sell_pad_ratio") <= 1.6:
        return Method.SELL_C_SIGMA
    # Heavy skew / mega-rows: exact-nnz scan handles any distribution.
    return Method.BALANCED


def choose_method(a: CsrMatrix, feats: MatrixFeatures = None) -> Method:
    """Pick the fastest plan for this matrix on TPU.

    Cost model: every plan's traffic is ≈ gather(nnz_effective) + streams.
    SELL's nnz_effective is nnz·pad_ratio but it has no scan pass and no
    scatter; the scan plans touch exactly nnz but add a cumsum pass.  So:
    prefer SELL while padding is modest; fall back to the tiled scan when
    padding explodes (extreme row-length skew) — the same regime where the
    reference switches from SELL to balanced2/CSR5.

    Without ``feats`` the features are computed lazily, cheapest first —
    an obviously banded matrix is routed to DIA after one structure probe
    instead of paying the multi-second SELL-8W tile estimate at 36M nnz
    (measured 10.2 s → 1.0 s on banded4m).
    """
    if feats is not None:
        return _decide(lambda k: getattr(feats, k))

    cache: dict = {"m": a.m, "n": a.n, "nnz": a.nnz}

    def lazy(k):
        if k in cache:
            return cache[k]
        if k in ("ndiags", "dia_fill"):
            from .formats.dia import dia_profile
            cache["ndiags"], cache["dia_fill"] = (
                dia_profile(a) if a.nnz else (0, 0.0))
        elif k in ("nblocks", "block_fill"):
            from .formats.bcsr import bcsr_profile
            cache["nblocks"], cache["block_fill"] = (
                bcsr_profile(a) if a.nnz else (0, 0.0))
        elif k == "sell8w_pad":
            from .formats.sell8w import (estimate_sell8w_tiles, WINDOW,
                                         split_megarows)
            if a.nnz:
                floor_pad = _pairs_floor_pad(a)
                if floor_pad > 32.0:
                    # past every sell8w_pad decision threshold — the
                    # floor decides; skip the estimator cascade
                    cache[k] = floor_pad
                    cache.setdefault("coo2_pad", floor_pad)
                    return cache[k]
                est = estimate_sell8w_tiles(a)
                a_split, subs = split_megarows(a)
                if subs is not None:
                    est = min(est, estimate_sell8w_tiles(a_split))
                cache[k] = est * WINDOW / a.nnz
            else:
                cache[k] = 1.0
        elif k == "coo2_pad":
            from .formats.sell8w import pairs_lower_bound, WINDOW
            pairs = pairs_lower_bound(a) if a.nnz else 0
            cache[k] = pairs * WINDOW / a.nnz if pairs else float("inf")
        elif k == "sell_pad_ratio":
            cache[k] = (_sell_pad_ratio(a.row_lengths.astype(np.int64))
                        if a.m else 1.0)
        else:
            raise KeyError(k)
        return cache[k]

    return _decide(lazy)


def _tune_cache_path(mtx_token: str) -> str:
    """The winner record of ``mtx_token``: ``$SPMV_TPU_TORCH_CACHE`` (by
    default ``~/.cache/spmv_tpu_torch``), never the JAX package's
    directory, whose winners were timed on another device."""
    import os
    d = os.environ.get("SPMV_TPU_TORCH_CACHE",
                       os.path.join(os.path.expanduser("~"), ".cache",
                                    "spmv_tpu_torch"))
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"tune_{mtx_token}.json")


def _device_name(dev) -> str:
    """The card's name (``torch.cuda.get_device_name``), or "cpu"."""
    import torch
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def tune(a: CsrMatrix, methods=None, iters: int = 5, repeats: int = 2,
         x=None, verbose: bool = False, mtx_token: str = None,
         budget_s: float = None, device="cuda", prices=None):
    """Measurement-based auto-tuner: build each candidate handle on
    ``device``, time it, return (best_handle, results).

    This completes the reference README's promised-but-empty "Matrix
    inspect and choose best method to run" (README.md:222-223) by running
    the candidates and keeping the winner.  ``choose_method`` remains the
    zero-cost heuristic Method.AUTO uses; ``tune`` is for
    inspect-once/execute-many workloads where a few seconds of tuning
    amortize.

    ``results`` maps a method's name to seconds per SpMV
    (``time_spmv_chain``'s inclusive time, k = 4), ``inf`` for a candidate
    that failed to plan or was skipped, or the cached winner's recorded
    time on a cache hit.  A planning refusal (``ValueError``,
    ``NotImplementedError``: DIA's or BCSR's "unprofitable", say) makes a
    candidate lose, and so does ``torch.cuda.OutOfMemoryError`` in its
    planning, placement or timing (the cache is emptied first); any other
    error of the card propagates, since it is sticky and would fail every
    later candidate too.

    ``mtx_token`` caches the winner on disk (the reference's partition
    cache, HyperGraphInterface.cpp:22-57): the second call skips the sweep
    and builds only the winner.  The record holds m, nnz, the dtype and the
    device's name; any mismatch is a miss, so a winner timed on another
    card or on the CPU never applies here.

    ``budget_s`` bounds the sweep's own wall time: once spent, the
    remaining candidates are skipped (``inf``) and the best so far wins.
    The record stores the sweep's cost as ``sweep_seconds``.

    ``prices`` goes to every ``create_handle`` (the price table; None is
    the JAX package's).
    """
    import json
    import os
    import time

    import torch

    from .bench import timing
    from .formats import _bf16
    from .handle import _resolve_device, _torch_dtype, create_handle, \
        plan_kind
    from .types import METHOD_NAMES, dtype_name

    dev = _resolve_device(device)
    record = {"m": int(a.m), "nnz": int(a.nnz),
              "dtype": dtype_name(a.dtype), "device": _device_name(dev)}
    if mtx_token:
        path = _tune_cache_path(mtx_token)
        if os.path.exists(path):
            with open(path) as f:
                rec = json.load(f)
            # a reused token must never apply another matrix's (or another
            # device's) winner; a stale winner that no longer plans (a DIA
            # pick after the matrix stopped being banded) re-sweeps
            if all(rec.get(k) == v for k, v in record.items()):
                try:
                    h = create_handle(a, method=Method(rec["method"]),
                                      device=dev, prices=prices)
                    return h, {METHOD_NAMES[h.method]:
                               rec.get("seconds", float("nan"))}
                except (ValueError, NotImplementedError):
                    pass

    if methods is None:
        # every distinct execution plan, CSR5 (the COO2/8D scattered
        # workhorse AUTO itself prefers for moderate scatter) and
        # BALANCED2 included
        methods = [Method.DIA, Method.BCSR, Method.SELL_C_SIGMA,
                   Method.CSR5, Method.BALANCED2, Method.BALANCED,
                   Method.SERIAL]
    if x is None:
        # x in the matrix's type, as the JAX tuner draws it: a bf16
        # matrix's x is rounded to bf16 (and passed as f32)
        x = np.random.default_rng(0).standard_normal(a.n)
        x = (_bf16.round_f32(x) if a.dtype == torch.bfloat16
             else x.astype(a.dtype))
    xt = torch.as_tensor(x).to(dev, _torch_dtype(a.dtype)).contiguous()

    sweep_t0 = time.perf_counter()
    best = None
    results = {}
    for method in methods:
        name = METHOD_NAMES[Method(method)]
        if (budget_s is not None and best is not None
                and time.perf_counter() - sweep_t0 > budget_s):
            results[name] = float("inf")      # skipped: budget spent
            if verbose:
                print(f"tune: {name} skipped (budget {budget_s:.1f}s "
                      "spent)")
            continue
        try:
            h = create_handle(a, method=method, device=dev, prices=prices)
            dt = timing.time_spmv_chain(h._bound, xt, iters=iters, k=4,
                                        repeats=repeats)["inclusive"]
        except (ValueError, NotImplementedError,
                torch.cuda.OutOfMemoryError) as e:
            # a refused plan, or one the card cannot hold, just loses; an
            # OOM is not sticky, so the sweep goes on once the handle is
            # dropped and the cache emptied
            h = None
            timing.empty_cache_after_oom(e)
            results[name] = float("inf")
            if verbose:
                print(f"tune: {name} failed: {e}")
            continue
        results[name] = dt
        if verbose:
            print(f"tune: {name}: {dt*1e3:.6f} ms/iter "
                  f"({plan_kind(h.plan)})")
        if best is None or dt < best[0]:
            best = (dt, h, Method(method))
    if best is None:
        raise RuntimeError("tune: every candidate method failed")
    if mtx_token:
        with open(_tune_cache_path(mtx_token), "w") as f:
            json.dump({"method": int(best[2]), "seconds": best[0], **record,
                       "sweep_seconds":
                           round(time.perf_counter() - sweep_t0, 3)}, f)
    return best[1], results
