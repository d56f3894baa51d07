#!/usr/bin/env python3
"""Drive the port's f32 AUTO main path on one NVIDIA card and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no ``"ok"`` line):

1. toolchain: the card's name and power limit, CUDA, nvcc, triton;
2. build: the host packers (g++) and the CUDA kernels (nvcc, sm_90a);
3. kernels: each kernel against its plain PyTorch version on the card —
   ``sell_row`` over f32/bf16/palette values, ``sell_slot`` over
   nw ∈ {1,2,4,8} × cell_w × the three value modes, ``dia`` over f32/bf16;
4. main path: the bench's f32 families (``bench.py``'s generator calls and
   seeds) through ``create_handle(a, device="cuda")`` and ``spmv``, checked
   against ``spmv_golden``, with the AUTO plan asserted and the launch
   counts read; then each family's kernels against their plain versions
   at the main path's shapes, and CUDA-event times of both.

Bound everywhere: |Δy_i| ≤ 1e-5·(|A||x|)_i (f32 sums in another order).
Output: one JSON line per family and one ``{"kernels": [...]}`` line, the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
BOUND = 1e-5
ITERS = 30

#: family → (generator call as in bench.py:_gen_one, AUTO plan, kernels)
FAMILIES = {
    "banded4m": (lambda g, np: g.banded(4_000_000, 4_000_000, 4,
                                        dtype=np.float32, seed=7),
                 "dia", ("dia",)),
    "clustered200k": (lambda g, np: g.clustered(200_000, 200_000, 32,
                                                spread=512,
                                                dtype=np.float32, seed=9),
                      "sell8d", ("sell_slot",)),
    "uniform100k": (lambda g, np: g.random_uniform(100_000, 100_000, 40,
                                                   dtype=np.float32,
                                                   seed=42),
                    "sell8d", ("sell_slot",)),
    "powerlaw100k": (lambda g, np: g.power_law(100_000, 100_000,
                                               40 * 100_000,
                                               dtype=np.float32, seed=2),
                     "hybrid(8w+8d)", ("sell_row", "sell_slot")),
}

KERNELS = {
    "sell_row": ("spmv_tpu_torch/csrc/sell.cu",
                 "spmv_tpu/ops/pallas_sell.py:202"),
    "sell_slot": ("spmv_tpu_torch/csrc/sell.cu",
                  "spmv_tpu/ops/pallas_sell.py:202"),
    "dia": ("spmv_tpu_torch/csrc/dia.cu", "spmv_tpu/ops/pallas_dia.py:43"),
}


def log(msg):
    print(msg, flush=True)


def _cmd_line(cmd):
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e.__class__.__name__})"
    out = (res.stdout or res.stderr).strip().splitlines()
    return out[-1] if out else f"exit {res.returncode}"


def cuda_ms(fn, x, iters=ITERS):
    """Median CUDA-event time of fn(x) in ms, after warm-up."""
    import torch
    for _ in range(3):
        fn(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn(x)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def scaled_err(y, ref, absref):
    """max_i |y_i - ref_i| / (|A||x|)_i, and whether all are within
    BOUND."""
    import torch
    d = (y.double() - ref.double()).abs()
    den = absref.double()
    ok = bool((d <= BOUND * den + 1e-30).all())
    ratio = torch.where(den > 0, d / den.clamp_min(1e-300),
                        torch.where(d > 0, float("inf"), 0.0))
    return float(ratio.max()) if ratio.numel() else 0.0, \
        float(d.max()) if d.numel() else 0.0, ok


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel wrapper to its plain version (to time the same
    plan without the kernels)."""
    from spmv_tpu_torch.ops import dia, sell
    saved = sell.sell_spmv, dia.dia_spmv
    sell.sell_spmv, dia.dia_spmv = sell.sell_plain, dia.dia_plain
    try:
        yield
    finally:
        sell.sell_spmv, dia.dia_spmv = saved


def abs_stream(st):
    import dataclasses
    return dataclasses.replace(
        st, palette=st.palette.abs(),
        vals=None if st.vals is None else st.vals.abs())


def abs_dia(p):
    import dataclasses
    return dataclasses.replace(p, data=p.data.abs())


def check_stream(kind, st, x, timing=False):
    """Kernel vs plain version on one stream; returns a record."""
    import torch
    from spmv_tpu_torch.ops import dia, sell
    if kind == "dia":
        run, plain = dia.dia_spmv, dia.dia_plain
        absref = dia.dia_plain(abs_dia(st), x.abs())
    else:
        run, plain = sell.sell_spmv, sell.sell_plain
        absref = sell.sell_plain(abs_stream(st), x.abs())
    y = run(st, x)
    ref = plain(st, x)
    torch.cuda.synchronize()
    rel, mabs, ok = scaled_err(y, ref, absref)
    if not ok:
        raise AssertionError(f"{kind}: kernel disagrees with its plain "
                             f"version (max scaled error {rel:.3g})")
    rec = {"max_scaled_err": rel, "max_abs_err": mabs}
    if timing:
        rec["ms"] = cuda_ms(lambda v: run(st, v), x)
        rec["plain_ms"] = cuda_ms(lambda v: plain(st, v), x)
    return rec


def kernel_phase(dev):
    """Coverage: every value mode, bundle width and cell_w setting."""
    import numpy as np
    import torch
    from spmv_tpu_torch.formats import dia as dia_fmt
    from spmv_tpu_torch.formats.sell8d import pack_sell8d
    from spmv_tpu_torch.formats.sell8w import pack_sell8w, plan_v2
    from spmv_tpu_torch.io import generate
    from spmv_tpu_torch.ops import dia, sell
    from spmv_tpu_torch.types import CsrMatrix

    rng = np.random.default_rng(0)

    def revalue(a, mode, entries):
        if mode == "palette":
            v = rng.integers(1, entries, a.nnz) / 8.0
        elif mode == "bf16":
            v = rng.integers(1, 256, a.nnz) / 32.0
        else:
            v = rng.standard_normal(a.nnz)
        return CsrMatrix(a.m, a.n, a.rowptr, a.colidx, v.astype(np.float32))

    def xvec(n):
        return torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)).to(dev)

    rows = []
    base = generate.clustered(50_000, 50_000, 24, spread=400,
                              dtype=np.float32, seed=1)
    for mode in ("f32", "bf16", "palette"):
        v2 = plan_v2(pack_sell8w(revalue(base, mode, 64)))
        assert v2.value_mode == mode, (mode, v2.value_mode)
        st = sell.prepare_sell(v2, dev, slot_mode=False)
        rec = check_stream("sell_row", st, xvec(base.n))
        rows.append({"kernel": "sell_row", "value_mode": mode, **rec})
    scat = generate.random_uniform(30_000, 300_000, 10, dtype=np.float32,
                                   seed=2)
    for nw in (1, 2, 4, 8):
        for cell_w in ((False,) if nw == 1 else (False, True)):
            for mode in ("f32", "bf16", "palette"):
                a = revalue(scat, mode, 64 >> (nw.bit_length() - 1))
                pk, _ = pack_sell8d(a, g="auto", max_pad_ratio=256.0,
                                    max_spill=0.05, nw=nw, cell_w=cell_w,
                                    force_value_mode=mode)
                st = sell.prepare_sell(pk, dev, slot_mode=True)
                rec = check_stream("sell_slot", st, xvec(a.n))
                rows.append({"kernel": "sell_slot", "nw": nw,
                             "cell_w": cell_w, "value_mode": mode, **rec})
    band = generate.banded(1_000_000, 1_000_200, 6, dtype=np.float32,
                           seed=3, exact=False)
    for mode in ("f32", "bf16"):
        d = dia_fmt.pack_dia(band, compress="none" if mode == "f32"
                             else "bf16")
        p = dia.prepare_dia(d, dev)
        rec = check_stream("dia", p, xvec(band.n))
        rows.append({"kernel": "dia", "value_mode": mode, **rec})
    for r in rows:
        log(json.dumps({"phase": "kernels", **r}))
    return max(r["max_abs_err"] for r in rows)


def profile_calls(fn, x, calls=20):
    """torch.profiler over ``calls`` back-to-back calls: device time per
    kernel name (per call), the window's wall time on CUDA events, and the
    share of that window the card ran no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn(x)
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s.record()
        for _ in range(calls):
            fn(x)
        e.record()
        e.synchronize()
    window = s.elapsed_time(e) / calls
    kernels = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0 and getattr(ev, "device_type", None) is not None \
                and "CUDA" in str(ev.device_type):
            kernels[ev.key[:80]] = us / 1e3 / calls
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return {"window_ms": window,
            "device_ms": busy if kernels else "not measured",
            "idle_share": (1 - busy / window) if kernels and window > 0
            else "not measured",
            "kernels_ms": dict(top)}


def family_streams(plan):
    """(kernel name, stream) pairs of a placed plan."""
    if "hybrid" in plan:
        return [s for p in plan["hybrid"] for s in family_streams(p)]
    if "sell8d" in plan:
        return [("sell_slot", plan["sell8d"])]
    if "sell8w_v2" in plan:
        return [("sell_row", plan["sell8w_v2"])]
    if "dia" in plan:
        return [("dia", plan["dia"])]
    return []


def main_path(dev):
    import numpy as np
    import torch
    import spmv_tpu_torch as st
    from spmv_tpu_torch.handle import plan_kind
    from spmv_tpu_torch.io import generate
    from spmv_tpu_torch.ops import dia, sell
    from spmv_tpu_torch.utils.profiling import predeal_profile

    handles, xs, mats, pre = {}, {}, {}, {}
    for name, (make, kind, _k) in FAMILIES.items():
        t0 = time.perf_counter()
        a = make(generate, np)
        t_gen = time.perf_counter() - t0
        t0 = time.perf_counter()
        with predeal_profile() as laps:
            h = st.create_handle(a, method=st.Method.AUTO, device=dev)
        predeal = time.perf_counter() - t0
        got = plan_kind(h.plan).replace("+rest", "")
        if got != kind:
            raise AssertionError(f"{name}: AUTO planned {got}, "
                                 f"expected {kind}")
        handles[name], mats[name] = h, a
        xs[name] = torch.from_numpy(np.random.default_rng(0)
                                    .standard_normal(a.n)
                                    .astype(np.float32)).to(dev)
        pre[name] = {"gen_ms": t_gen * 1e3,
                     "pack_ms": (predeal - laps["transfer_s"]) * 1e3,
                     "transfer_ms": laps["transfer_s"] * 1e3,
                     "plan_mb": laps["bytes"] / 1e6}
        log(f"# {name}: {h!r} predeal {predeal * 1e3:.0f} ms")

    # the counted run: every count to 0, the main path once, read back
    sell.row_launches = sell.slot_launches = dia.launches = 0
    ys = {name: st.spmv(h, xs[name]) for name, h in handles.items()}
    torch.cuda.synchronize()
    launches = {"sell_row": sell.row_launches,
                "sell_slot": sell.slot_launches, "dia": dia.launches}
    log(json.dumps({"phase": "main_path_launches", **launches}))

    kern = {k: {"max_abs_err": 0.0} for k in KERNELS}
    for name, h in handles.items():
        a, x = mats[name], xs[name]
        _make, _kind, need = FAMILIES[name]
        for k in need:
            if launches[k] == 0:
                raise AssertionError(f"{name}: kernel {k} was not launched")
        xh = x.cpu().numpy().astype(np.float64)
        gold = torch.from_numpy(st.spmv_golden(a.astype(np.float64), xh))
        aa = st.CsrMatrix(a.m, a.n, a.rowptr, a.colidx, np.abs(a.vals))
        absref = torch.from_numpy(st.spmv_golden(aa.astype(np.float64),
                                                 np.abs(xh)))
        y = ys[name].cpu()
        if y.shape != (a.m,) or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{name}: bad output {tuple(y.shape)}")
        rel, mabs, ok = scaled_err(y, gold, absref)
        if not ok:
            raise AssertionError(f"{name}: max scaled error {rel:.3g} "
                                 f"against spmv_golden")
        ms = cuda_ms(h, x)
        with plain_kernels():
            y_plain = h(x)
            plain_ms = cuda_ms(h, x)
        rel_p, _, ok_p = scaled_err(y_plain.cpu(), gold, absref)
        if not ok_p:
            raise AssertionError(f"{name}: plain path scaled error "
                                 f"{rel_p:.3g}")
        prof = profile_calls(h, x)
        streams = []
        for k, stream in family_streams(h.plan):
            rec = check_stream(k, stream, x, timing=True)
            kern[k]["max_abs_err"] = max(kern[k]["max_abs_err"],
                                         rec["max_abs_err"])
            # per kernel, keep the times at its largest main-path stream
            size = (stream.meta.numel() if k != "dia"
                    else stream.data.numel())
            if size >= kern[k].get("size", -1):
                kern[k].update(size=size, ms=rec["ms"],
                               plain_ms=rec["plain_ms"], family=name)
            streams.append({"kernel": k, "value_mode":
                            getattr(stream, "value_mode", None) or
                            str(stream.data.dtype).replace("torch.", ""),
                            "nw": getattr(stream, "nw", None),
                            "cell_w": getattr(stream, "cell_w", None),
                            "g": getattr(stream, "g", None),
                            "tiles": (stream.meta.shape[0]
                                      if k != "dia" else None), **rec})
        nnz = a.nnz
        log(json.dumps({
            "family": name, "plan": plan_kind(h.plan),
            "value_mode": h.plan.get("value_mode"),
            "nw": h.plan.get("nw"), "m": a.m, "n": a.n, "nnz": nnz,
            **pre[name], "ms": ms, "gflops": 2 * nnz / ms / 1e6,
            "plain_ms": plain_ms, "plain_gflops": 2 * nnz / plain_ms / 1e6,
            "max_scaled_err": rel, "max_abs_err": mabs,
            "profile": prof, "streams": streams}))
    return launches, kern


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "spmv_tpu_torch")):
        print("chip_smoke.py: no spmv_tpu_torch package beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    smi = _cmd_line(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"])
    from spmv_tpu_torch import _build
    from spmv_tpu_torch.native import native_available
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "not installed"
    nvcc = _build.nvcc_path()
    log(json.dumps({"phase": "toolchain", "gpu": smi,
                    "torch": torch.__version__, "cuda": torch.version.cuda,
                    "nvcc": _cmd_line([nvcc, "--version"]) if nvcc
                    else None, "triton": triton_v,
                    "python": sys.version.split()[0]}))
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    if not native_available():
        raise RuntimeError("the native host packer did not build")
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    lib = _build.load_kernels()
    t_cuda = time.perf_counter() - t0
    log(json.dumps({"phase": "build", "native_s": t_native,
                    "cuda_s": t_cuda, "library": lib._name}))
    with open(lib._name + ".log") as f:
        ptxas = f.read()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
    spills = [int(b) for b in re.findall(r"(\d+) bytes spill", ptxas)]
    log(json.dumps({"phase": "ptxas", "kernels": len(regs),
                    "registers_max": max(regs, default=0),
                    "spill_bytes": sum(spills)}))

    kernel_phase(dev)
    launches, kern = main_path(dev)
    kernels = []
    for name, (src, rep) in KERNELS.items():
        k = kern[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[name],
                        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                        "plain_ms": k["plain_ms"], "family": k["family"]})
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:  # noqa: BLE001 — report the failed phase, no "ok"
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
