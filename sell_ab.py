#!/usr/bin/env python3
"""Time the SELL and COO2 pass-1 kernels and the calibration's probe kernels
of another checkout of the port beside this one's, in one process on one
NVIDIA card, on each kernel's largest stream.

    python3 sell_ab.py OTHER_ROOT [--rounds R] [--kernels K,...]
    python3 sell_ab.py OTHER_ROOT --kernels tiny,fma_err
    python3 sell_ab.py OTHER_ROOT --routes
    python3 sell_ab.py OTHER_ROOT --streams

OTHER_ROOT is the root of another checkout (for example the parent
commit, unpacked with ``git archive`` into a directory that ``.gitignore``
lists).  Its ``spmv_tpu_torch`` is imported under another name beside this
checkout's; its kernels build into its own ``_build/``.  Every stream is
packed once, on the host, by this checkout's planners (the two trees'
packers are the same), and placed by each tree's own ``prepare_sell`` or
``prepare_v1``, so each tree runs its own chunk tables and kernel on the
same tiles.

Streams, one a kernel name (the largest each kernel runs in
``chip_smoke.py``): ``sell_row`` powerlaw100k's 8W part; ``sell_slot`` the
largest stripe of uniform250k_4m_d64; ``sell_row_df`` powerlaw100k_f64's
8W part; ``sell_slot_df`` the largest stripe of clustered2500k_s64_f64;
``sell_row_bin`` clustered200k_w4096's R; ``sell_row_w`` and
``sell_row_df_w`` clustered2500k_s64 and its f64 form as ``sell8w_v2w``;
``sell_slot_w`` (K6) uniform250k_4m_d64 and ``sell_slot_df_w``
clustered2500k_s64_f64 as one windowed slot stream; ``sell_v1`` (K9)
webbase1m_dist1's heavy stream and one shard of clustered200k_8w_dist4;
``sell_v1_df`` powerlaw100k_f64_dist1's dense stream; ``sell_v1_bin``
clustered200k's v1 pack, binary; ``coo2_pass1`` (K8) the pass-1 streams
of clustered200k_csr5 and clustered200k_w4096 (bf16 values) and of
``chip_smoke.py``'s kernel phase (f32 values), each packed once by
``pack_coo2`` as the CSR5 plan packs it and placed by each tree's
``prepare_coo2``.

The calibration's probe kernels (``csrc/probes.cu``), on the inputs the
probes give them from clustered200k (``probes.probe_inputs``):
``tile_stream`` on P1's four streams (S_big, S_tile, S_tile8, S_nodep; P7
runs S_tile's and S_tile8's) and P3's, each beside ``torch.sum`` over the
same tiles; ``tile_body`` on P2's stream, P4's three, P5's seven and P5's
full body at G 8, on a random x and carry; ``window_gather`` on P9's
loop and wide forms (g 32, 2048 steps, ``probes.p9_arrays``), each beside
the bound of its adds.  Each tree's own wrapper (``bench.probes``) runs
them; this tree's must give the same y bit for bit on three calls.
``tiny`` (P6) and ``fma_err`` (P8), which the launch binds, run on their
(8, 128) tiles, held bit for bit to their plain versions, and are also
timed as an eager chain of 100 dependent calls; then ``tiny``'s chains
from C without and with programmatic dependent launch, which only this
tree has (``tiny_chains``).

Per stream: both trees' y against the plain version (f32 1e-5, f64 1e-12
of (|A||x|)_i; COO2 pass 1 bit for bit; the probe kernels 1e-5 of the sum
of magnitudes), then R rounds in turns (other, this, this, other), each
side timed by ``chip_smoke.profile_calls`` (5 profile windows, warm and
after an L2 flush) and CUDA events, and its host time per call over 1,000
enqueues.  Prints one JSON line a stream: each side's medians over its
turns, the ratio this / other, ns a tile and the share of the padded
stream's bound; then the card's ``nvidia-smi`` line.  Exits non-zero
without a card or when a kernel disagrees with its plain version.

``--routes`` times no kernel: it plans ``chip_smoke.PRICE_FAMILIES`` at
full size under the other checkout's ``H100`` price table and this one's
(``route_ab``), to list the routes a re-derived table moves.

``--streams`` times no kernel: it runs ``chip_smoke.py``'s streams check
(``two_streams``: calls on two CUDA streams at once, behind one gate) on
every SELL stream of ``chip_smoke.STREAM_FAMILIES``'s plans, placed by
each tree, in turns (other, this, this, other; R · 50 rounds a turn),
every y held bit for bit to this tree's y of its x on one stream (x and
x reversed, in turns); one JSON line a stream with each side's rounds
and calls that gave another y and the tickets each turn left nonzero.
Fails when this tree gives another y.
"""

import argparse
import importlib.util
import itertools
import json
import os
import statistics
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
OTHER = "other_spmv_tpu_torch"


def load_other(root, name=OTHER):
    """``root``'s spmv_tpu_torch package, imported as ``name`` (its imports
    are relative, so it stays apart from this checkout's)."""
    pkg = os.path.join(os.path.abspath(root), "spmv_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def host_fields(st):
    """A placed stream's arrays on the host: ("v1", prepare_v1's keyword
    arguments) or ("v2", a namespace prepare_sell reads, slot mode)."""
    import numpy as np
    import torch

    def h(t):
        if t is None:
            return None
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16)
        return t.cpu().numpy()

    if st.gpk is not None:
        return "v1", dict(window_ids=h(st.tinfo), gpk=h(st.gpk),
                          meta=h(st.meta), vals=h(st.vals),
                          nslices=8 * st.nblocks, m=st.m, n=st.n,
                          vals_lo=h(st.vals_lo))
    pal = h(st.palette)
    return "v2", (SimpleNamespace(
        value_mode=st.value_mode,
        nslices=st.nblocks if st.slot_mode else 8 * st.nblocks, g=st.g,
        nw=st.nw, cell_w=st.cell_w, m=st.m, n=st.n,
        ginfo=(h(st.step_block) << 1).astype(np.int32), tinfo=h(st.tinfo),
        meta=h(st.meta), vals=h(st.vals), vals_lo=h(st.vals_lo),
        palette=pal, palette_lo=np.zeros_like(pal)), st.slot_mode)


def place(sell, fields, dev):
    kind, f = fields
    if kind == "v1":
        kw = dict(f)
        return sell.prepare_v1(kw.pop("window_ids"), kw.pop("gpk"),
                               kw.pop("meta"), kw.pop("vals"),
                               kw.pop("nslices"), kw.pop("m"), kw.pop("n"),
                               dev, vals_lo=kw.pop("vals_lo"))
    ns, slot = f
    return sell.prepare_sell(ns, dev, slot_mode=slot)


def streams(dev, kernels=None):
    """(label, placed stream) of each kernel's largest stream (only the
    kernel names in ``kernels`` when given), packed and placed by this
    checkout."""
    import numpy as np
    import chip_smoke as cs
    import spmv_tpu_torch as tt
    from spmv_tpu_torch import handle as th, parallel
    from spmv_tpu_torch.formats.sell8w import pack_sell8w
    from spmv_tpu_torch.io import generate
    from spmv_tpu_torch.ops import sell

    def matrix(family):
        return (cs._webbase1m if family == "webbase1m"
                else cs.FAMILIES[family][0])(generate, np)

    def largest(family, kernel):
        plan = tt.create_handle(matrix(family),
                                method=getattr(tt.Method,
                                               cs.method_of(family)),
                                device=dev).plan
        got = [s for s, _c in cs.family_streams(plan)
               if cs.kernel_of(s) == kernel]
        return max(got, key=lambda s: s.meta.shape[0])

    def windowed(family, build):
        placed = th._place(build(matrix(family)), dev)
        return placed.get("sell8d", placed.get("sell8w_v2w"))

    def shard(family, part, kernel):
        base, ndev, build = cs.DIST_FAMILIES[family][:3]
        a = matrix(base)
        mesh = parallel.make_mesh_1d(ndev, device=dev)
        if build == "auto":
            parts = parallel.build_dist_auto(a, mesh).parts
        else:
            parts = {"sell8w": parallel.build_dist_sell8w_plan(
                a, mesh, x_mode=build.split(":")[1], max_pad_ratio=32.0)}
        return [st for k, q in parts.items() if hasattr(q, "streams")
                and (part is None or k == part) for st in q.streams
                if cs.kernel_of(st) == kernel][0]

    def v1_binary():
        p = pack_sell8w(matrix("clustered200k"))
        return sell.prepare_v1(p.window_ids, sell.pack_gpk(p.slice_ids),
                               sell.binary_meta_v1(p), None, p.nslices,
                               p.m, p.n, dev)

    todo = [
        ("sell_row", "powerlaw100k 8W",
         lambda: largest("powerlaw100k", "sell_row")),
        ("sell_row_df", "powerlaw100k_f64 8W",
         lambda: largest("powerlaw100k_f64", "sell_row_df")),
        ("sell_row_bin", "clustered200k_w4096 R",
         lambda: largest("clustered200k_w4096", "sell_row_bin")),
        ("sell_slot", "uniform250k_4m_d64 stripe",
         lambda: largest("uniform250k_4m_d64", "sell_slot")),
        ("sell_slot_w", "uniform250k_4m_d64 windowed",
         lambda: windowed("uniform250k_4m_d64", cs.windowed_slot_plan)),
        ("sell_row_w", "clustered2500k_s64 sell8w_v2w",
         lambda: windowed("clustered2500k_s64", cs.windowed_row_plan)),
        ("sell_slot_df", "clustered2500k_s64_f64 stripe",
         lambda: largest("clustered2500k_s64_f64", "sell_slot_df")),
        ("sell_row_df_w", "clustered2500k_s64_f64 sell8w_v2w",
         lambda: windowed("clustered2500k_s64_f64", cs.windowed_row_plan)),
        ("sell_slot_df_w", "clustered2500k_s64_f64 windowed",
         lambda: windowed("clustered2500k_s64_f64", cs.windowed_slot_plan)),
        ("sell_v1", "webbase1m_dist1 heavy",
         lambda: shard("webbase1m_dist1", "heavy", "sell_v1")),
        ("sell_v1", "clustered200k_8w_dist4 shard",
         lambda: shard("clustered200k_8w_dist4", None, "sell_v1")),
        ("sell_v1_df", "powerlaw100k_f64_dist1 dense",
         lambda: shard("powerlaw100k_f64_dist1", None, "sell_v1_df")),
        ("sell_v1_bin", "clustered200k v1 pack, binary", v1_binary),
    ]
    for kernel, label, build in todo:
        if kernels is None or kernel in kernels:
            yield label, build()


def coo2_packs(kernels=None):
    """(label, COO2 pack) of K8's streams, packed by this checkout as the
    CSR5 plan packs them (``pack_coo2(a, max_pad2=8.0)``)."""
    if kernels is not None and "coo2_pass1" not in kernels:
        return
    import numpy as np
    import chip_smoke as cs
    from spmv_tpu_torch.formats.coo2 import pack_coo2
    from spmv_tpu_torch.io import generate
    for label, make in (
            ("clustered200k_csr5 pass 1",
             lambda: cs.FAMILIES["clustered200k_csr5"][0](generate, np)),
            ("clustered200k_w4096 pass 1",
             lambda: cs.FAMILIES["clustered200k_w4096"][0](generate, np)),
            ("kernel phase f32 pass 1",
             lambda: generate.clustered(100_000, 100_000, 24, spread=2048,
                                        dtype=np.float32, seed=1,
                                        exact=False))):
        yield label, pack_coo2(make(), max_pad2=8.0)


def nchunks(st):
    """A placed stream's CUDA blocks: its chunks, or for a COO2 plan its
    pass-1 chunks (a tree without them ran a block a tile)."""
    if hasattr(st, "window_ids"):
        ptr = getattr(st, "chunk_ptr", None)
        return st.ntiles if ptr is None else ptr.numel() - 1
    return st.nchunks


def probe_jobs(dev, other_pr, kernels=None):
    """(kernel, label, {side: fn of the carry}, tiles, (bytes, operations),
    check, carry) of the probe kernels' streams; ``check(y)`` is (scaled
    error, within 1e-5) against the plain version, or for ``tiny`` and
    ``fma_err`` (positions differing in bits, none)."""
    import dataclasses
    import numpy as np
    import torch
    import chip_smoke as cs
    from spmv_tpu_torch.bench import probes as pr
    from spmv_tpu_torch.io import generate

    def checker(plain, plain_abs):
        ref, absref = plain(), plain_abs()

        def check(y):
            rel, _abs, ok = cs.scaled_err(y.reshape(-1), ref.reshape(-1),
                                          absref.reshape(-1), cs.BOUND)
            return rel, ok
        return check

    def exact(ref):
        return lambda y: (int(cs.bit_diff(y, ref)), torch.equal(y, ref))

    rng = np.random.default_rng(0)
    v, a8, b8 = (torch.from_numpy(rng.standard_normal((8, 128)).astype(
        np.float32)).to(dev) for _ in range(3))
    p8 = a8 * b8
    if kernels is None or "tiny" in kernels:
        yield ("tiny", "P6 tile", {"other": other_pr.tiny, "this": pr.tiny},
               1, (8192, 1024), exact(pr.tiny_plain(v)), v)
    if kernels is None or "fma_err" in kernels:
        yield ("fma_err", "P8 tile",
               {"other": lambda t: other_pr.fma_err(t, b8, p8),
                "this": lambda t: pr.fma_err(t, b8, p8)},
               1, (16384, 2048), exact(pr.fma_err_plain(a8, b8, p8)), a8)
    if kernels is None or "window_gather" in kernels:
        g, nsteps = 32, 2048
        loop, wide, x, _oracle = pr.p9_arrays(g)
        xd = torch.from_numpy(x).to(dev)
        for label, w, arrs in (("P9 loop", False, loop),
                               ("P9 wide", True, wide + (None,))):
            a0, a1, a2 = (None if v is None else torch.from_numpy(v).to(dev)
                          for v in arrs)
            yield ("window_gather", label,
                   {"other": lambda v, w=w, a0=a0, a1=a1, a2=a2:
                    other_pr.window_gather(w, a0, a1, a2, v, nsteps),
                    "this": lambda v, w=w, a0=a0, a1=a1, a2=a2:
                    pr.window_gather(w, a0, a1, a2, v, nsteps)},
                   g * nsteps,
                   (sum(v.nbytes for v in arrs if v is not None)
                    + x.nbytes + 4096, g * nsteps * 1024),
                   checker(lambda w=w, a0=a0, a1=a1, a2=a2:
                           pr.window_gather_plain(w, a0, a1, a2, xd),
                           lambda w=w, a0=a0, a1=a1, a2=a2:
                           pr.window_gather_plain(w, a0, a1, a2,
                                                  xd.abs())), xd)
    if kernels is not None and not {"tile_stream", "tile_body"} & set(
            kernels):
        return
    _a, packed, v2 = pr.probe_inputs(cs.FAMILIES["clustered200k"][0](
        generate, np))
    vals = torch.from_numpy(packed.vals).to(dev)
    if kernels is None or "tile_stream" in kernels:
        ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        ones = torch.ones(8, 128, dtype=torch.float32, device=dev)
        for label, block, acc in pr.STREAM_INPUTS:
            nt = vals.shape[0] // block * block
            if nt == 0:
                continue
            sides = {"other": lambda c, b=block, a=acc: other_pr.tile_stream(
                vals, b, a, c, ticket),
                "this": lambda c, b=block, a=acc: pr.tile_stream(
                    vals, b, a, c),
                "torch_sum": lambda c, n=nt: torch.sum(vals[:n], 0)}
            if not acc:
                del sides["torch_sum"]
            yield ("tile_stream", label, sides, nt,
                   (nt * 4096 + (1 if acc else nt // block + 1) * 4096, 0),
                   checker(lambda b=block, a=acc: pr.tile_stream_plain(
                       vals, b, a, ones),
                       lambda b=block, a=acc: pr.tile_stream_plain(
                           vals.abs(), b, a, ones)), ones)
    if kernels is None or "tile_body" in kernels:
        rng = np.random.default_rng(3)
        c0 = torch.from_numpy(rng.standard_normal((8, 128)).astype(
            np.float32)).to(dev)
        for label, b in pr.body_inputs(packed, v2, dev):
            b = dataclasses.replace(b, x=torch.from_numpy(
                rng.standard_normal(b.x.numel()).astype(np.float32)).to(dev))
            babs = dataclasses.replace(
                b, palette=b.palette.abs(), x=b.x.abs(),
                vals=None if b.vals is None else b.vals.abs())
            yield ("tile_body", label,
                   {"other": lambda c, b=b: other_pr.tile_body(b, c),
                    "this": lambda c, b=b: pr.tile_body(b, c)}, b.ntiles,
                   (cs.body_bytes(b), 0),
                   checker(lambda b=b: pr.tile_body_plain(b, c0),
                           lambda b=babs: pr.tile_body_plain(b, c0.abs())),
                   c0)


#: the probe kernels the launch binds: ``probe_ab`` also times them as an
#: eager chain of dependent calls
LAUNCH_BOUND = ("tiny", "fma_err")


def probe_ab(dev, other_pr, rounds, kernels=None):
    """Each probe stream: both trees against the plain version, this
    tree's three calls bit for bit, then ``rounds`` turns (other, this,
    this, other), ``torch.sum`` measured once after them; one JSON line a
    stream with ns a tile and the bound's share of the device times, and
    for :data:`LAUNCH_BOUND` the eager chain's ms a call."""
    import chip_smoke as cs
    for kernel, label, fns, nt, (nbytes, ops), check, c in probe_jobs(
            dev, other_pr, kernels):
        errs = {}
        for side in ("other", "this"):
            rel, ok = check(fns[side](c))
            errs[side] = rel
            if not ok:
                raise AssertionError(f"{kernel} {label} ({side}): scaled "
                                     f"error {rel:.3g}")
        cs.repeats_its_y(f"{kernel} {label}", fns["this"], c)
        chain = kernel in LAUNCH_BOUND
        runs = {"other": [], "this": []}
        for _ in range(rounds):
            for side in ("other", "this", "this", "other"):
                runs[side].append(measure(fns[side], c, chain))
        if "torch_sum" in fns:
            runs["torch_sum"] = [measure(fns["torch_sum"], c)]
        bound, by = cs._bound_ms(nbytes, ops)
        rec = {"kernel": kernel, "stream": label, "tiles": nt,
               "bytes": nbytes, "operations": ops, "bound_ms": bound,
               "bound_by": by, "scaled_err": errs}
        for side, rs in runs.items():
            med = {k: statistics.median(r[k] for r in rs)
                   for k in ("device_ms", "cold_device_ms", "ms", "host_us",
                             "eager_chain_ms")
                   if all(isinstance(r.get(k), float) for r in rs)}
            for k in ("device_ms", "cold_device_ms", "ms", "eager_chain_ms"):
                if k in rs[0]:
                    med[f"{k}_turns"] = [r[k] for r in rs]
            for k in ("device_ms", "cold_device_ms"):
                if k in med:
                    med[f"ns_tile_{k}"] = med[k] * 1e6 / nt
                    med[f"bound_share_{k}"] = bound / med[k]
            rec[side] = med
        if "device_ms" in rec["this"] and "device_ms" in rec["other"]:
            rec["this_over_other"] = (rec["this"]["device_ms"]
                                      / rec["other"]["device_ms"])
            rec["this_over_other_cold"] = (
                rec["this"].get("cold_device_ms", float("nan"))
                / rec["other"].get("cold_device_ms", float("nan")))
        for k in ("ms", "eager_chain_ms"):
            if k in rec["this"] and k in rec["other"]:
                rec[f"this_over_other_{k}"] = (rec["this"][k]
                                               / rec["other"][k])
        cs.log(json.dumps(rec))


def tiny_chains(dev, rounds, kernels=None):
    """``tiny``'s chains from C (``probes.tiny_chain``, which the other
    tree does not have): ``2 · rounds`` turns, each holding one chain of
    ``probes.CHAIN_LAUNCHES`` launches without and then with programmatic
    dependent launch bit for bit to v·2^100 and timing it
    (``probes.chain_ms``); one JSON line, the medians and the turns."""
    if kernels is not None and "tiny" not in kernels:
        return
    import numpy as np
    import torch
    import chip_smoke as cs
    from spmv_tpu_torch.bench import probes as pr
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 128)).astype(np.float32)).to(dev)
    want = pr.tiny_chain_plain(v, pr.CHAIN_LAUNCHES)
    turns = {"chain": [], "chain_pdl": []}
    for _ in range(2 * rounds):
        for pdl, key in ((False, "chain"), (True, "chain_pdl")):
            if not torch.equal(pr.tiny_chain(v, pr.CHAIN_LAUNCHES, pdl),
                               want):
                raise AssertionError(f"tiny_chain (pdl {pdl}): not "
                                     "v·2^100 bit for bit")
            turns[key].append(pr.chain_ms(v, pdl))
    rec = {"kernel": "tiny", "stream": "chains from C",
           "launches": pr.CHAIN_LAUNCHES}
    for key, cs_ in turns.items():
        for k in ("ms", "host_us"):
            rec[f"{key}_{k}"] = statistics.median(c[k] for c in cs_)
            rec[f"{key}_{k}_turns"] = [c[k] for c in cs_]
    cs.log(json.dumps(rec))


def route_ab(dev, other_prices):
    """Each of ``chip_smoke.PRICE_FAMILIES`` planned by this checkout's
    ``create_handle`` (AUTO) under three tables: the other checkout's
    ``H100`` (``old``), this one's (``new``), and ``old`` with only this
    one's two x prices, ``stripe_x_ns_per_byte`` and ``x_window_ns``
    (``old_x``), which tells a route the x prices moved from one the other
    figures moved.  One JSON line a family with the three routes; where
    ``old`` and ``new`` differ, both plans' y against the family's
    reference and bound, and both timed in turns (old, new, new, old: CUDA
    events, median of 30) with a profile each."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    import chip_smoke as cs
    import spmv_tpu_torch as st
    from spmv_tpu_torch.formats import prices as pm
    from spmv_tpu_torch.io import generate
    old = pm.Prices(**dataclasses.asdict(other_prices.H100))
    tables = {"old": old, "new": pm.H100,
              "old_x": dataclasses.replace(
                  old, stripe_x_ns_per_byte=pm.H100.stripe_x_ns_per_byte,
                  x_window_ns=pm.H100.x_window_ns)}
    for name in cs.PRICE_FAMILIES:
        a = cs.FAMILIES[name][0](generate, np)
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(a.n)
                             .astype(a.vals.dtype)).to(dev)
        hs = {k: st.create_handle(a, method=st.Method.AUTO, device=dev,
                                  prices=t) for k, t in tables.items()}
        row = {"routes": name, **{f"route_{k}": cs.route_of(h)
                                  for k, h in hs.items()}}
        row["differs"] = row["route_old"] != row["route_new"]
        if row["differs"]:
            ref, absref, bound, _ref_name = cs.reference(
                a, x.cpu().numpy().astype(np.float64), np)
            ref, absref = torch.from_numpy(ref), torch.from_numpy(absref)
            ms = {"old": [], "new": []}
            for k in ms:
                rel, _abs, ok = cs.scaled_err(hs[k](x).cpu(), ref, absref,
                                              bound,
                                              cs.scan_atol(hs[k], a, ref))
                if not ok:
                    raise AssertionError(f"routes {name}: the {k} plan's "
                                         f"max scaled error {rel:.3g}")
                row[f"scaled_err_{k}"] = rel
            for k in ("old", "new", "new", "old"):
                ms[k].append(cs.cuda_ms(hs[k], x))
            for k in ms:
                row[f"ms_{k}"] = ms[k]
                row[f"device_ms_{k}"] = cs.profile_calls(hs[k],
                                                         x)["device_ms"]
        cs.log(json.dumps(row))
        del hs, a, x
        gc.collect()
        torch.cuda.empty_cache()


def family_sell_streams(dev, family):
    """The SELL streams of ``family``'s plan in ``chip_smoke.py``, planned
    by this checkout: a main-path family's handle (its method as the
    script plans it), or a dist family's mesh plan (its shard streams)."""
    import numpy as np
    import chip_smoke as cs
    import spmv_tpu_torch as tt
    from spmv_tpu_torch import parallel
    from spmv_tpu_torch.io import generate
    if family in cs.DIST_FAMILIES:
        base, ndev = cs.DIST_FAMILIES[family][:2]
        plan = cs.dist_family_plan(
            family, cs.FAMILIES[base][0](generate, np),
            parallel.make_mesh_1d(ndev, device=dev))
        sts = [st for q in plan.parts.values() if hasattr(q, "streams")
               for st in q.streams if st is not None]
    else:
        h = tt.create_handle(cs.FAMILIES[family][0](generate, np),
                             method=getattr(tt.Method, cs.method_of(family)),
                             device=dev)
        sts = [st for st, _c in cs.family_streams(h.plan)]
    return [st for st in sts if cs.kernel_of(st).startswith("sell")]


def stream_ab(dev, other, this, rounds):
    """The streams check on both trees: every SELL stream of
    ``chip_smoke.STREAM_FAMILIES``'s plans (:func:`family_sell_streams`),
    placed by each tree, called on two CUDA streams at once in turns
    (other, this, this, other), each turn ``rounds`` of
    ``chip_smoke.two_streams``; every y held bit for bit to this tree's y
    on one stream, and the other tree's tickets set to 0 before each of
    its turns.  One JSON line a stream.  Returns the count of this tree's
    calls that gave another y."""
    import numpy as np
    import torch
    import chip_smoke as cs
    rng = np.random.default_rng(0)
    failed = 0
    for family in cs.STREAM_FAMILIES:
        for i, st in enumerate(family_sell_streams(dev, family)):
            fields = host_fields(st)
            sides = {"other": place(other, fields, dev),
                     "this": place(this, fields, dev)}
            x = torch.from_numpy(rng.standard_normal(st.n).astype(
                np.float64 if st.dtype == torch.float64
                else np.float32)).to(dev)
            want = [this.sell_spmv(sides["this"], v)
                    for v in cs.stream_xs(x)]
            torch.cuda.synchronize()
            per_block = np.diff(st.block_chunk_ptr.cpu().numpy())
            rec = {"streams": family, "stream": i,
                   "kernel": cs.kernel_of(st), "chunks": st.nchunks,
                   "nblocks": st.nblocks,
                   "blocks_of_several_chunks": int((per_block > 1).sum()),
                   "rounds_a_turn": rounds}
            runs = {"other": [], "this": []}
            for side in ("other", "this", "this", "other"):
                mod, s = (other, this)[side == "this"], sides[side]
                if hasattr(s, "ticket"):
                    s.ticket.zero_()
                r = cs.two_streams(lambda v, f=mod.sell_spmv, s=s: f(s, v),
                                   x, rounds=rounds, want=want)
                sets = ([s.ticket] if hasattr(s, "ticket")
                        else list(s.tickets_by_stream.values()))
                r["tickets_left"] = sum(int(t.count_nonzero())
                                        for t in sets)
                runs[side].append(r)
            for side, rs in runs.items():
                rec[side] = {k: sum(r[k] for r in rs) for k in
                             ("rounds", "wrong_rounds", "wrong_calls")}
                rec[side]["tickets_left_a_turn"] = [r["tickets_left"]
                                                    for r in rs]
            failed += rec["this"]["wrong_calls"]
            cs.log(json.dumps(rec))
            del sides, st, x, want
        torch.cuda.empty_cache()
    return failed


def measure(fn, x, chain=False):
    """Device time warm and cold (``chip_smoke.profile_calls``), one call
    (CUDA events), the host's µs a call, and with ``chain`` the ms a call
    of an eager chain of 100 dependent calls, best of 3 (the probe's
    ``tiny_pallas_ms`` method)."""
    import chip_smoke as cs
    from spmv_tpu_torch.bench import timing
    warm = cs.profile_calls(fn, x)
    cold = cs.profile_calls(fn, x, cold=True)
    rec = {"device_ms": warm["device_ms"],
           "device_ms_spread": warm.get("device_ms_spread"),
           "cold_device_ms": cold["device_ms"],
           "cold_device_ms_spread": cold.get("device_ms_spread"),
           "ms": cs.cuda_ms(fn, x), "host_us": timing.host_us(fn, x)}
    if chain:
        rec["eager_chain_ms"] = min(timing.time_op_samples(
            fn, x, iters=100, repeats=3)) * 1e3
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=1,
                    help="turns (other, this, this, other) per stream")
    ap.add_argument("--kernels", default=None,
                    help="comma-separated kernel names (default: all)")
    ap.add_argument("--routes", action="store_true",
                    help="plan the price families under both trees' H100 "
                    "tables instead of timing kernels")
    ap.add_argument("--streams", action="store_true",
                    help="run the two-stream check on both trees' SELL "
                    "streams instead of timing kernels")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sell_ab.py: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import chip_smoke as cs
    from spmv_tpu_torch.ops import coo2 as this_coo2, sell as this
    load_other(args.other)
    dev = torch.device("cuda", 0)
    if args.routes:
        route_ab(dev, importlib.import_module(OTHER + ".formats.prices"))
        cs.log(cs._cmd_line(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"]))
        return 0
    other = importlib.import_module(OTHER + ".ops.sell")
    if args.streams:
        failed = stream_ab(dev, other, this, args.rounds * cs.STREAM_ROUNDS)
        cs.log(cs._cmd_line(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"]))
        return 1 if failed else 0
    other_coo2 = importlib.import_module(OTHER + ".ops.coo2")
    rng = np.random.default_rng(0)
    kernels = args.kernels and args.kernels.split(",")

    def sell_jobs():
        for label, st in streams(dev, kernels):
            fields = host_fields(st)
            del st
            yield label, {"other": place(other, fields, dev),
                          "this": place(this, fields, dev)}, \
                {"other": other.sell_spmv, "this": this.sell_spmv}

    def coo2_jobs():
        for label, packed in coo2_packs(kernels):
            yield label, {"other": other_coo2.prepare_coo2(packed, dev),
                          "this": this_coo2.prepare_coo2(packed, dev)}, \
                {"other": other_coo2.coo2_pass1,
                 "this": this_coo2.coo2_pass1}

    t0 = time.perf_counter()
    for label, sides, runs_of in itertools.chain(sell_jobs(), coo2_jobs()):
        pack_s = time.perf_counter() - t0
        st = sides["this"]
        coo2 = cs.is_coo2(st)
        x = torch.from_numpy(rng.standard_normal(st.n).astype(
            np.float32 if coo2 or st.dtype != torch.float64
            else np.float64)).to(dev)
        plain = this_coo2.coo2_pass1_plain if coo2 else this.sell_plain
        ref = plain(st, x)
        absref = plain(cs.abs_stream(st), x.abs())
        bound = (cs.BOUND_F64_KERNEL if x.dtype == torch.float64
                 else cs.BOUND)
        errs = {}
        for side, s in sides.items():
            y = runs_of[side](s, x)
            rel, _abs, ok = cs.scaled_err(y, ref, absref, bound)
            if coo2:
                # one f32 product a slot: bit for bit
                rel = int(cs.bit_diff(y, ref))
                ok = rel == 0
            errs[side] = rel
            if not ok:
                what = "positions differing in bits" if coo2 else \
                    "scaled error"
                raise AssertionError(f"{label} ({side}): {what} {rel:.3g}")
        runs = {"other": [], "this": []}
        for _ in range(args.rounds):
            for side in ("other", "this", "this", "other"):
                runs[side].append(measure(
                    lambda v, f=runs_of[side], s=sides[side]: f(s, v), x))
        nt = st.meta.shape[0]
        stream_ms = cs.stream_bound(st, 0)[3]
        rec = {"kernel": cs.kernel_of(st), "stream": label, "tiles": nt,
               "pack_s": pack_s, "value_mode": cs.value_mode_of(st),
               "nw": getattr(st, "nw", None),
               "chunks": {s: nchunks(sides[s]) for s in sides},
               "bit_diff" if coo2 else "scaled_err": errs,
               "stream_bound_ms": stream_ms}
        for side, rs in runs.items():
            med = {k: statistics.median(r[k] for r in rs)
                   for k in ("device_ms", "cold_device_ms", "ms", "host_us")
                   if all(isinstance(r[k], float) for r in rs)}
            med["device_ms_turns"] = [r["device_ms"] for r in rs]
            med["cold_device_ms_turns"] = [r["cold_device_ms"] for r in rs]
            med["spreads"] = [r["device_ms_spread"] for r in rs]
            if "device_ms" in med:
                med["ns_tile"] = med["device_ms"] * 1e6 / nt
                med["bound_share"] = stream_ms / med["device_ms"]
            rec[side] = med
        if "device_ms" in rec["this"] and "device_ms" in rec["other"]:
            rec["this_over_other"] = (rec["this"]["device_ms"]
                                      / rec["other"]["device_ms"])
        cs.log(json.dumps(rec))
        del sides, st, x, ref, absref
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
    other_pr = importlib.import_module(OTHER + ".bench.probes")
    probe_ab(dev, other_pr, args.rounds, kernels)
    tiny_chains(dev, args.rounds, kernels)
    cs.log(cs._cmd_line(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
