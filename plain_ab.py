#!/usr/bin/env python3
"""Time the plain plans (the routes the JAX package runs through XLA) of
another checkout of the port beside this one's, in one process on one
NVIDIA card, and count how often each repeats its own y.

    python3 plain_ab.py OTHER_ROOT

OTHER_ROOT is the root of another checkout (for example the parent
commit, unpacked with ``git archive`` into a directory that ``.gitignore``
lists); its ``spmv_tpu_torch`` is imported under another name beside this
checkout's, as ``sell_ab.py`` does, and builds its kernels into its own
``_build/``.  Each family's matrix is generated once (``chip_smoke.py``'s
generator calls) and planned by each tree's own ``create_handle`` (or
``build_dist_auto``), so each side runs its own sums on the same plan.

Families: ``chip_smoke.py``'s plain run (powerlaw100k under Balanced,
BalancedYid, Balanced2 and its f64 form under Balanced2: the scans;
uniform100k's chunked SELL-C-σ; block512_bcsr: BCSR), webbase1m through
AUTO (the graph plan with its straggler stream), uniform100k under
``Method.SERIAL`` (one segment sum over 4M nonzeros) and powerlaw100k on a
4-shard ``build_dist_auto`` scan (the mesh's prefix sums).

Per family and side: CALLS calls on one x, and how many give the first
call's y bit for bit; the y against the family's reference within
``chip_smoke.py``'s bound (a scan's with its absolute term); then one
round in turns (other, this, this, other), each side timed by
``chip_smoke.profile_calls`` (device ms of 5 windows of 20 calls, its
costliest kernels) and CUDA events (median of 30).

Then the layouts of this tree's fixed-order prefix sum
(``torch_csr.prefix_sum``), each swapped in on this tree's handles of the
families in SCAN_FAMILIES, whose routes run it over their streams and
their tiles' carries: past ``ONE_ROW``, rows of ``SCAN_ROW`` = 32 to 4096
scanned by PyTorch's row scan, and runs of 32 or 128 scanned down the
columns of their transpose (PyTorch's outer-dimension scan, also one
thread a run).  Each layout, in turns forward and back, is
held to the family's bound and must repeat its y over CALLS calls.

Prints one JSON line a family and a layout, then the card's ``nvidia-smi``
line.  Exits non-zero without a card or when a y misses its bound.
"""

import argparse
import json
import os
import statistics
import sys

from sell_ab import load_other

ROOT = os.path.dirname(os.path.abspath(__file__))
#: calls on one x for the repeat count
CALLS = 20
#: family → (the matrix: a chip_smoke.FAMILIES name, the method asked for,
#: VectorizedWay, mesh shards or 0 for one handle)
PLAIN = {
    "powerlaw100k_balanced": ("powerlaw100k_balanced", "BALANCED", "VPU", 0),
    "powerlaw100k_balanced_yid": ("powerlaw100k_balanced", "BALANCED_YID",
                                  "VPU", 0),
    "powerlaw100k_balanced2": ("powerlaw100k_balanced", "BALANCED2", "VPU",
                               0),
    "powerlaw100k_f64_balanced2": ("powerlaw100k_f64_balanced2",
                                   "BALANCED2", "VPU", 0),
    "uniform100k_chunked": ("uniform100k_chunked", "SELL_C_SIGMA", "NONE",
                            0),
    "block512_bcsr": ("block512_bcsr", "AUTO", "VPU", 0),
    "webbase1m": ("webbase1m", "AUTO", "VPU", 0),
    "uniform100k_serial": ("uniform100k_chunked", "SERIAL", "VPU", 0),
    "powerlaw100k_dist4": ("powerlaw100k_balanced", "AUTO", "VPU", 4),
}
#: this tree's handles the prefix-sum layouts are timed on (their routes
#: run ``torch_csr.prefix_sum`` over their streams)
SCAN_FAMILIES = ("powerlaw100k_balanced", "powerlaw100k_balanced_yid",
                 "powerlaw100k_balanced2", "powerlaw100k_f64_balanced2",
                 "powerlaw100k_dist4")
#: (layout, run): ("rows", R) is ``torch_csr.prefix_sum`` with SCAN_ROW R,
#: ("columns", R) :func:`prefix_sum_columns`; both scan a sum no longer
#: than ``torch_csr.ONE_ROW`` as one row
SCAN_LAYOUTS = (("rows", 32), ("rows", 128), ("rows", 256), ("rows", 1024),
                ("rows", 4096), ("columns", 32), ("columns", 128))


def build(pkg, a, method, vec, shards, dev):
    """The family's plan in tree ``pkg`` (its own CsrMatrix of ``a``)."""
    mat = pkg.CsrMatrix(a.m, a.n, a.rowptr, a.colidx, a.vals)
    if shards:
        return pkg.parallel.build_dist_auto(
            mat, pkg.parallel.make_mesh_1d(shards, device=dev))
    return pkg.create_handle(mat, method=getattr(pkg.Method, method),
                             vectorized=getattr(pkg.VectorizedWay, vec),
                             device=dev)


def repeats(fn, x, calls):
    """How many of ``calls`` calls give the first call's y bit for bit."""
    import torch
    y = fn(x)
    return 1 + sum(bool(torch.equal(y, fn(x))) for _ in range(calls - 1))


def atol_of(fn, a, ref):
    """The scan plans' absolute term (``chip_smoke.scan_atol``'s, and the
    dist scan's on its largest shard)."""
    import chip_smoke as cs
    if hasattr(fn, "plan"):
        return cs.scan_atol(fn, a, ref)
    if fn.kind != "scan":
        return 0.0
    shard_nnz = max(int(t.numel()) for t in fn.parts["scan"].vals_pad)
    return 2e-4 * (shard_nnz / 150_000) ** 0.5


def timed(fn, x):
    """One turn: device ms (``chip_smoke.profile_calls``), CUDA-event ms,
    the idle share and the costliest kernels."""
    import chip_smoke as cs
    prof = cs.profile_calls(fn, x)
    return {"device_ms": prof["device_ms"], "ms": cs.cuda_ms(fn, x),
            "idle_share": prof.get("idle_share"),
            "kernels_ms": prof.get("kernels_ms")}


def prefix_sum_columns(run, one_row):
    """``torch_csr.prefix_sum`` with each ``run`` items scanned down one
    column of their transpose (PyTorch's outer-dimension scan, one thread
    a run, in order), the carry over the runs' totals taken the same way;
    ``one_row`` (``torch_csr.prefix_sum``) up to ``torch_csr.ONE_ROW``."""
    import torch
    from spmv_tpu_torch.ops import torch_csr

    def prefix_sum(v):
        n = v.shape[0]
        if n <= torch_csr.ONE_ROW:
            return one_row(v)
        nruns = max(-(-n // run), 2)
        t = v.new_zeros(nruns * run)
        t[:n] = v
        local = torch.cumsum(t.view(nruns, run).t(), dim=0)
        if n > run:
            carry = prefix_sum(local[-1].contiguous())
            local[:, 1:] += carry[None, :-1]
        return local.t().reshape(-1)[:n]
    return prefix_sum


def scan_layouts(scans, gpu):
    """Each of SCAN_LAYOUTS swapped into ``torch_csr`` under this tree's
    handles in ``scans`` (family → (handle, x, reference, |A||x|, bound,
    matrix)): held to the bound, CALLS calls bit for bit, timed in turns
    forward and back; one JSON line a layout."""
    import chip_smoke as cs
    from spmv_tpu_torch.ops import torch_csr
    own_row, own_sum = torch_csr.SCAN_ROW, torch_csr.prefix_sum
    recs = {lay: {"scan_layout": lay[0], "run": lay[1], "gpu": gpu,
                  "families": {}} for lay in SCAN_LAYOUTS}
    try:
        for lay in SCAN_LAYOUTS + SCAN_LAYOUTS[::-1]:
            kind, run = lay
            torch_csr.SCAN_ROW = run if kind == "rows" else own_row
            torch_csr.prefix_sum = (own_sum if kind == "rows"
                                    else prefix_sum_columns(run, own_sum))
            for name, (h, x, ref, absref, bound, a) in scans.items():
                fam = recs[lay]["families"].setdefault(name, {"turns": []})
                if not fam["turns"]:
                    rel, _m, ok = cs.scaled_err(h(x).cpu(), ref, absref,
                                                bound, atol_of(h, a, ref))
                    if not ok:
                        raise AssertionError(f"{name} ({kind} {run}): max "
                                             f"scaled error {rel:.3g}")
                    fam.update(max_scaled_err=rel,
                               repeats=repeats(h, x, CALLS), calls=CALLS)
                fam["turns"].append(timed(h, x))
    finally:
        torch_csr.SCAN_ROW, torch_csr.prefix_sum = own_row, own_sum
    for rec in recs.values():
        for fam in rec["families"].values():
            fam["device_ms"] = statistics.median(
                t["device_ms"] for t in fam["turns"])
            fam["ms"] = statistics.median(t["ms"] for t in fam["turns"])
        cs.log(json.dumps(rec))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="root of the other checkout")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("plain_ab.py: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import chip_smoke as cs
    import spmv_tpu_torch as this
    from spmv_tpu_torch.io import generate
    other = load_other(args.other)
    dev = torch.device("cuda", 0)
    gpu = cs._cmd_line(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"])
    mats, scans = {}, {}
    for name, (base, method, vec, shards) in PLAIN.items():
        if base not in mats:
            mats[base] = cs.FAMILIES[base][0](generate, np)
        a = mats[base]
        sides = {"other": build(other, a, method, vec, shards, dev),
                 "this": build(this, a, method, vec, shards, dev)}
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(a.n)
                             .astype(a.vals.dtype)).to(dev)
        ref, absref, bound, ref_name = cs.reference(
            a, x.cpu().numpy().astype(np.float64), np)
        ref, absref = torch.from_numpy(ref), torch.from_numpy(absref)
        rec = {"family": name, "gpu": gpu, "method": method,
               "shards": shards, "nnz": a.nnz, "reference": ref_name}
        for side, fn in sides.items():
            rel, _m, ok = cs.scaled_err(fn(x).cpu(), ref, absref, bound,
                                        atol_of(fn, a, ref))
            if not ok:
                raise AssertionError(f"{name} ({side}): max scaled error "
                                     f"{rel:.3g} against {ref_name}")
            rec[side] = {"max_scaled_err": rel,
                         "repeats": repeats(fn, x, CALLS),
                         "calls": CALLS, "turns": []}
        for side in ("other", "this", "this", "other"):
            rec[side]["turns"].append(timed(sides[side], x))
        for side in sides:
            turns = rec[side]["turns"]
            for k in ("device_ms", "ms"):
                vals = [t[k] for t in turns if isinstance(t[k], float)]
                rec[side][k] = statistics.median(vals) if vals else None
        if rec["this"]["device_ms"] and rec["other"]["device_ms"]:
            rec["this_over_other"] = (rec["this"]["device_ms"]
                                      / rec["other"]["device_ms"])
        cs.log(json.dumps(rec))
        if name in SCAN_FAMILIES:
            scans[name] = (sides["this"], x, ref, absref, bound, a)
        del sides, x, ref, absref
        torch.cuda.empty_cache()
    scan_layouts(scans, gpu)
    cs.log(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
