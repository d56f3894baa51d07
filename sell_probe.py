#!/usr/bin/env python3
"""Probes of the SELL kernel (``spmv_tpu_torch/csrc/sell.cu``) on one
NVIDIA card: where its time goes, and whether its one-launch epilogue is
sound.  Run from the repository root:

    python3 sell_probe.py chunks      # the chunk rule's settings
    python3 sell_probe.py variants    # copies of the kernel, one part changed
    python3 sell_probe.py stress      # partial-sum scratch poisoned with NaN
    python3 sell_probe.py probes      # the calibration's probe kernels
    python3 sell_probe.py streams     # two CUDA streams, fence left out
    python3 sell_probe.py launch      # tiny and fma_err, PDL left out

Streams are those of ``sell_ab.py`` (each SELL kernel's largest stream in
``chip_smoke.py``), packed once on the host.  Each prints one JSON line a
stream; device times are ``chip_smoke.profile_calls``' median of 5
profile windows.

* ``chunks``: the stream placed under other values of
  ``ops.sell.CHUNKS_PER_SM`` and ``ops.sell.MAX_REDUCE_BYTES`` (the shipped
  pair first), each checked against the plain version and timed.
* ``variants``: ``sell.cu`` compiled again with one change each, into
  ``spmv_tpu_torch/_build/variants/``, and timed on K6's, a K1 slot
  stripe's and K9's stream: ``nogather`` (slot x gathers replaced by a
  constant: wrong results, timed only), ``nocell`` (the cell's meta read
  from the slot's own word: wrong results), ``ku1``/``ku4`` (tiles
  decoded at once), ``ring32`` (32 KB rings).
* ``stress``: 300 launches a stream at 2 and 4 chunks an SM (output
  blocks of many chunks), each after the block the caching allocator hands
  out as the partial-sum scratch was filled with NaN; every launch must
  match the plain version and the first launch's bits, and leave the
  tickets at 0.

* ``probes``: the same for the calibration's ``tile_stream`` and
  ``tile_body`` (``csrc/probes.cu``) on the probes' clustered200k inputs
  (P1 S_big; P4 f32, P5's full body, no_gather and no_mask): copies with
  the fixed-order reduce left out (``notail``), the zero-fill of groups no
  tile visits left out (``nozero``), the runs' stores left out
  (``noflush``), the cell's meta read from the slot's own word
  (``nocell``) — each giving wrong results, timed only — and ``ku4``
  (tiles decoded at once); then ``tile_stream`` and PyTorch's flat
  ``sum`` over P1's tiles repeated 1, 2 and 4 times, each call timed by
  CUDA events after ``probes.flush_l2`` (the cold times' flush: 256 MB
  rewritten in place) and after a read of 1 GiB, which leaves the L2
  clean.
* ``streams``: ``chip_smoke.py``'s streams check (``two_streams``: calls
  on two CUDA streams at once, behind one gate; 500 rounds) on every SELL
  stream of ``chip_smoke.STREAM_FAMILIES``' plans, on the shipped kernel
  and on a copy without the proxy fence before a stage is handed back to
  the bulk copies (``nofence``: ``csrc/tma.cuh`` ``fence_stage_reads``),
  each y held bit for bit to the shipped kernel's y of its x on one
  stream; the rounds and calls that gave another y, a stream a line.
* ``launch``: ``tiny`` (P6) and ``fma_err`` (P8) from copies of
  ``probes.cu`` that take apart what their redesign changed at once:
  ``noattr`` (launched without the programmatic-serialization attribute,
  the ``griddepcontrol`` instructions kept), ``nogdc`` (neither the
  attribute nor the instructions), ``ldg`` (PDL kept, inputs read through
  the read-only path, ``__ldg``, as before the redesign; timed only, since
  a PDL grid may be alive while its predecessor writes) and ``parent``
  (``nogdc`` and ``ldg``: the kernels as before the redesign, launched
  through ``cudaLaunchKernelEx``).  ``ROUNDS`` rounds of turns (the
  shipped kernels, each copy, the shipped kernels), each variant's device
  time (``chip_smoke.profile_calls``) and one call (CUDA events); one
  JSON line a kernel with every variant's median and its ratio to the
  shipped kernels'.

Exits non-zero without a card, or when ``stress`` finds a launch wrong,
``streams`` a wrong y of the shipped kernel or ``launch`` a shipped
kernel not bit for bit its plain version.
"""

import argparse
import concurrent.futures
import ctypes
import dataclasses
import json
import os
import statistics
import subprocess
import sys
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))

CHUNK_SETTINGS = [(2, 1 << 20), (2, 1 << 18), (2, 1 << 40), (1, 1 << 20),
                  (4, 1 << 20)]
VARIANTS = {
    "nogather": [("? __ldg(x + base[u] + off[u][i]) : T(0);",
                  "? T(off[u][i]) : T(0);")],
    "nocell": [("const uint32_t mc = mt[i * kLanes + (ms & 127u)];",
                "const uint32_t mc = ms;")],
    "ku1": [("constexpr int kU = 2;", "constexpr int kU = 1;")],
    "ku4": [("constexpr int kU = 2;", "constexpr int kU = 4;")],
    "ring32": [("constexpr int kRingBytes = 16 * 1024;",
                "constexpr int kRingBytes = 32 * 1024;")],
}

PROBE_VARIANTS = {
    "notail": [("  take_tickets(tr, &slot, 1, &last);", "  last = 0;"),
               ("    take_tickets(p.tr, slots, n, last);",
                "    if (tid < n) last[tid] = 0;\n    __syncthreads();")],
    "nozero": [("for (int64_t z = z0; z < z1; ++z) {",
                "for (int64_t z = z0; z < z0; ++z) {")],
    "noflush": [("            dst[r * kLanes + j] = acc[r];",
                 "            if (acc[r] == 12345.f) "
                 "dst[r * kLanes + j] = acc[r];")],
    "nocell": [("(uint32_t(mt[i * kLanes + r]) >> 7)", "(ms >> 7)")],
    "ku4": [("constexpr int kBodyU = 2;", "constexpr int kBodyU = 4;")],
}
PROBE_ENTRIES = ("spmv_probe_tile_stream", "spmv_probe_tile_body")
FENCE_VARIANTS = {
    "nofence": [("        fence_stage_reads();\n        __syncwarp();\n"
                 "        if ((l & 31) == 0) mbar_arrive(&empty[s]);",
                 "        __syncwarp();\n"
                 "        if ((l & 31) == 0) mbar_arrive(&empty[s]);")]}
#: rounds of the streams probe, a stream and kernel
FENCE_ROUNDS = 500
_NO_ATTR = ("Allowed = pdl ? 1 : 0;", "Allowed = 0;")
_NO_GDC = [('"griddepcontrol.launch_dependents;"', '""'),
           ('"griddepcontrol.wait;"', '""'), _NO_ATTR]
_LDG = [("const float4 a = __ldcg(v + threadIdx.x);",
         "const float4 a = __ldg(v + threadIdx.x);"),
        ("__fmaf_rn(__ldcg(a + i), __ldcg(b + i), -__ldcg(p + i))",
         "__fmaf_rn(__ldg(a + i), __ldg(b + i), -__ldg(p + i))")]
LAUNCH_VARIANTS = {"noattr": [_NO_ATTR], "nogdc": _NO_GDC, "ldg": _LDG,
                   "parent": _NO_GDC + _LDG}
LAUNCH_ENTRIES = ("spmv_probe_tiny", "spmv_probe_fma_err")
#: rounds of turns of the launch probe
LAUNCH_ROUNDS = 5


def build_variants(source="sell.cu", variants=VARIANTS,
                   entries=("spmv_sell_launch",)):
    """(the shipped kernels, {name: {entry: function}}) of each variant of
    ``source``, compiled at once."""
    from spmv_tpu_torch import _build
    base = _build.load_kernels()
    src = open(os.path.join(_build.CSRC_DIR, source)).read()
    vdir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(vdir, exist_ok=True)
    cmd = [_build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", _build.CSRC_DIR]

    def build(name):
        text = src
        for old, new in variants[name]:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in {source}")
            text = text.replace(old, new)
        path = os.path.join(vdir, name + ".cu")
        with open(path, "w") as f:
            f.write(text)
        res = subprocess.run(cmd + [path, "-o", path[:-3] + ".so"],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"variant {name}: {res.stderr[-2000:]}")
        lib = ctypes.CDLL(path[:-3] + ".so")
        fns = {}
        for entry in entries:
            fn = getattr(lib, entry)
            fn.restype = getattr(base, entry).restype
            fn.argtypes = getattr(base, entry).argtypes
            fns[entry] = fn
        return name, fns

    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        fns = dict(pool.map(build, variants))
    fns["base"] = {entry: getattr(base, entry) for entry in entries}
    return base, fns


def probe_kernels(dev):
    """The ``probes`` subcommand: one JSON line a variant, then one a
    stream size."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from spmv_tpu_torch import _build
    from spmv_tpu_torch.bench import probes as pr
    from spmv_tpu_torch.io import generate
    _a, packed, v2 = pr.probe_inputs(cs.FAMILIES["clustered200k"][0](
        generate, np))
    vals = torch.from_numpy(packed.vals).to(dev)
    ones = torch.ones(8, 128, dtype=torch.float32, device=dev)
    bodies = dict(pr.body_inputs(packed, v2, dev))
    runs = {"P1 S_big": (lambda c: pr.tile_stream(vals, 64, True, c),
                         lambda c: pr.tile_stream_plain(vals, 64, True, c),
                         lambda c: pr.tile_stream_plain(vals.abs(), 64,
                                                        True, c))}
    for name in ("P4 f32", "P5 full G16", "P5 no_gather G16",
                 "P5 no_mask G16"):
        b = bodies[name]
        babs = dataclasses.replace(b, palette=b.palette.abs(),
                                   vals=None if b.vals is None
                                   else b.vals.abs())
        runs[name] = (lambda c, b=b: pr.tile_body(b, c),
                      lambda c, b=b: pr.tile_body_plain(b, c),
                      lambda c, b=babs: pr.tile_body_plain(b, c))
    base, fns = build_variants("probes.cu", PROBE_VARIANTS, PROBE_ENTRIES)
    for name in ("base", *PROBE_VARIANTS, "base"):
        _build._kernels = SimpleNamespace(**{**vars(base), **fns[name]})
        rec = {"probe": "probes", "variant": name}
        for label, (fn, plain, plain_abs) in runs.items():
            ok = cs.scaled_err(fn(ones).reshape(-1), plain(ones).reshape(-1),
                               plain_abs(ones).reshape(-1), cs.BOUND)[2]
            rec[label] = {"ok": ok,
                          "device_ms": cs.profile_calls(fn, ones)["device_ms"]}
        cs.log(json.dumps(rec))
    _build._kernels = base

    # the cold times' flush, and a read of 1 GiB, which leaves no dirty
    # line in the L2 and lasts past the host's enqueue of the timed call
    scratch = torch.zeros(1 << 28, dtype=torch.int32, device=dev)
    flushes = {"dirty": lambda: pr.flush_l2(dev),
               "clean": lambda: torch.amax(scratch)}

    def one_call_ms(fn, flush, iters=20):
        fn(ones)
        torch.cuda.synchronize()
        ms = []
        for _ in range(iters):
            flush()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn(ones)
            e.record()
            e.synchronize()
            ms.append(s.elapsed_time(e))
        return statistics.median(ms)

    for reps in (1, 2, 4):
        v = vals.repeat(reps, 1, 1)
        flat = v.view(-1)
        rec = {"probe": "probes", "tiles": v.shape[0],
               "bound_ms": v.numel() * 4 / cs.HBM_BYTES_PER_S * 1e3}
        for kind, flush in flushes.items():
            rec[f"tile_stream_{kind}_ms"] = one_call_ms(
                lambda c, v=v: pr.tile_stream(v, 64, True, c), flush)
            rec[f"flat_sum_{kind}_ms"] = one_call_ms(
                lambda c, f=flat: f.sum(), flush)
        cs.log(json.dumps(rec))
        del v, flat


def stream_fence(dev):
    """The ``streams`` subcommand: one JSON line a stream; returns the
    shipped kernel's calls that gave another y."""
    import numpy as np
    import torch
    import chip_smoke as cs
    import sell_ab
    from spmv_tpu_torch import _build
    from spmv_tpu_torch.ops import sell
    base, fns = build_variants(variants=FENCE_VARIANTS)
    rng = np.random.default_rng(0)
    failed = 0
    for family in cs.STREAM_FAMILIES:
        for i, st in enumerate(sell_ab.family_sell_streams(dev, family)):
            x = torch.from_numpy(rng.standard_normal(st.n).astype(
                np.float64 if st.dtype == torch.float64
                else np.float32)).to(dev)
            want = [sell.sell_spmv(st, v) for v in cs.stream_xs(x)]
            rec = {"probe": "streams", "family": family, "stream": i,
                   "kernel": cs.kernel_of(st), "chunks": st.nchunks,
                   "nblocks": st.nblocks}
            for name in ("base", *FENCE_VARIANTS, "base"):
                _build._kernels = SimpleNamespace(**{**vars(base),
                                                     **fns[name]})
                r = cs.two_streams(lambda v: sell.sell_spmv(st, v), x,
                                   rounds=FENCE_ROUNDS, want=want)
                rec.setdefault(name, []).append(
                    {k: r[k] for k in ("wrong_rounds", "wrong_calls")})
                if name == "base":
                    failed += r["wrong_calls"]
            _build._kernels = base
            rec["rounds"] = FENCE_ROUNDS
            cs.log(json.dumps(rec))
            del st, x, want
        torch.cuda.empty_cache()
    return failed


def launch_kernels(dev):
    """The ``launch`` subcommand: one JSON line a kernel; returns the
    shipped kernels' calls that were not their plain version bit for
    bit."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from spmv_tpu_torch import _build
    from spmv_tpu_torch.bench import probes as pr
    rng = np.random.default_rng(0)
    v, a8, b8 = (torch.from_numpy(rng.standard_normal((8, 128)).astype(
        np.float32)).to(dev) for _ in range(3))
    p8 = a8 * b8
    runs = {"tiny": (pr.tiny, pr.tiny_plain(v), v),
            "fma_err": (lambda t: pr.fma_err(t, b8, p8),
                        pr.fma_err_plain(a8, b8, p8), a8)}
    base, fns = build_variants("probes.cu", LAUNCH_VARIANTS, LAUNCH_ENTRIES)
    got = {kernel: {} for kernel in runs}
    failed = 0
    for _ in range(LAUNCH_ROUNDS):
        for name in ("base", *LAUNCH_VARIANTS, "base"):
            _build._kernels = SimpleNamespace(**{**vars(base), **fns[name]})
            for kernel, (fn, want, x) in runs.items():
                r = got[kernel].setdefault(name, {"wrong": 0, "device_ms": [],
                                                  "ms": []})
                wrong = not torch.equal(fn(x), want)
                r["wrong"] += wrong
                failed += wrong and name == "base"
                r["device_ms"].append(cs.profile_calls(fn, x)["device_ms"])
                r["ms"].append(cs.cuda_ms(fn, x))
    _build._kernels = base
    for kernel, by_name in got.items():
        rec = {"probe": "launch", "kernel": kernel, "rounds": LAUNCH_ROUNDS}
        for name, r in by_name.items():
            rec[name] = {"wrong": r["wrong"],
                         "device_ms": statistics.median(r["device_ms"]),
                         "ms": statistics.median(r["ms"]),
                         "device_ms_turns": r["device_ms"],
                         "ms_turns": r["ms"]}
        for name in LAUNCH_VARIANTS:
            for k in ("device_ms", "ms"):
                rec[name][f"over_base_{k}"] = (rec[name][k]
                                               / rec["base"][k])
        cs.log(json.dumps(rec))
    return failed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("probe", choices=("chunks", "variants", "stress",
                                      "probes", "streams", "launch"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sell_probe.py: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import chip_smoke as cs
    import sell_ab
    from spmv_tpu_torch import _build
    from spmv_tpu_torch.ops import sell
    dev = torch.device("cuda", 0)
    if args.probe in ("probes", "streams", "launch"):
        failed = 0
        if args.probe == "probes":
            probe_kernels(dev)
        elif args.probe == "launch":
            failed = launch_kernels(dev)
        else:
            failed = stream_fence(dev)
        cs.log(cs._cmd_line(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"]))
        return 1 if failed else 0
    rng = np.random.default_rng(0)
    kernels = {"variants": ["sell_slot_w", "sell_slot", "sell_v1"],
               "stress": ["sell_row", "sell_row_df", "sell_v1",
                          "sell_v1_df", "sell_slot_w"]}.get(args.probe)
    if args.probe == "variants":
        base, fns = build_variants()
    defaults = sell.CHUNKS_PER_SM, sell.MAX_REDUCE_BYTES
    failed = 0
    for label, st in sell_ab.streams(dev, kernels):
        fields = sell_ab.host_fields(st)
        kern = cs.kernel_of(st)
        del st
        x = None
        rec = {"probe": args.probe, "kernel": kern, "stream": label}
        for cps, mrb in (CHUNK_SETTINGS if args.probe == "chunks"
                         else [(defaults[0], defaults[1])]
                         + ([(4, defaults[1])] if args.probe == "stress"
                            else [])):
            sell.CHUNKS_PER_SM, sell.MAX_REDUCE_BYTES = cps, mrb
            s2 = sell_ab.place(sell, fields, dev)
            sell.CHUNKS_PER_SM, sell.MAX_REDUCE_BYTES = defaults
            if x is None:
                x = torch.from_numpy(rng.standard_normal(s2.n).astype(
                    np.float64 if s2.dtype == torch.float64
                    else np.float32)).to(dev)
                ref = sell.sell_plain(s2, x)
                absref = sell.sell_plain(cs.abs_stream(s2), x.abs())
                bound = (cs.BOUND_F64_KERNEL if x.dtype == torch.float64
                         else cs.BOUND)
                rec.update(tiles=s2.meta.shape[0], nw=s2.nw,
                           nblocks=s2.nblocks)
            fn = lambda v: sell.sell_spmv(s2, v)  # noqa: E731
            key = f"cps{cps}_reduce{mrb}"
            most = int(np.diff(s2.block_chunk_ptr.cpu().numpy()).max())
            if args.probe == "chunks":
                ok = cs.scaled_err(fn(x), ref, absref, bound)[2]
                rec[key] = {"chunks": s2.nchunks, "most_a_block": most,
                            "ok": ok,
                            "device_ms": cs.profile_calls(fn, x)["device_ms"]}
            elif args.probe == "variants":
                for name in ("base", *VARIANTS, "base"):
                    _build._kernels = SimpleNamespace(
                        **{**vars(base), **fns[name]})
                    ok = cs.scaled_err(fn(x), ref, absref, bound)[2]
                    rec.setdefault(name, []).append(
                        {"ok": ok,
                         "device_ms": cs.profile_calls(fn, x)["device_ms"]})
                _build._kernels = base
            else:
                y0 = fn(x).clone()
                wrong = differ = 0
                worst = 0.0
                for _ in range(300):
                    torch.full((s2.nchunks * 1024,), float("nan"),
                               dtype=s2.dtype, device=dev)
                    y = fn(x)
                    rel, _abs, ok = cs.scaled_err(y, ref, absref, bound)
                    wrong += not ok
                    differ += not torch.equal(y, y0)
                    worst = max(worst, rel)
                left = sum(int(t.count_nonzero())
                           for t in s2.tickets_by_stream.values())
                failed += wrong + differ + left
                rec[key] = {"chunks": s2.nchunks, "most_a_block": most,
                            "launches": 300, "wrong": wrong,
                            "differ": differ, "worst_scaled_err": worst,
                            "tickets_left": left}
            del s2
        cs.log(json.dumps(rec))
        del x, ref, absref
        torch.cuda.empty_cache()
    cs.log(cs._cmd_line(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"]))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
