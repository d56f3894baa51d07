"""The headline benchmark (the port of the root ``bench.py``): nine
generated families, each planned with ``Method.AUTO`` on one device and
timed with the chained protocol, one compact JSON line on stdout and the
full record on disk.

    python3 bench_torch.py [--device cuda] [--out-dir DIR]

Per family: generate the matrix (``bench.py``'s generators, sizes and
seeds), build its handle under ``predeal_profile`` (the pre-deal: host
pack and transfer), drop the host CSR, then time ``time_spmv_chain(h._bound,
x, iters=10, k=32, repeats=2)`` in two windows 15 s apart, every family in
turn within a window, and keep the best.  One family's exception is
recorded as its ``error`` and the run goes on; the exit code is 1 when no
family lands.  The device is CUDA unless ``--device cpu`` is asked for:
without a card the bench says so and exits 2, having measured nothing.

The last stdout line is compact (under 1,900 characters): per family
``g`` (GF/s), ``vr`` (over the reference library's CPU figure), ``pk`` and
``tx`` (pack and transfer ms), or ``e: 1`` for a failed family.  The full
record (every field, each window's time, the card's ``nvidia-smi`` name and
power limit, the timing protocol) goes to
``chiprun_out/bench_torch_latest.json`` under the checkout, or ``--out-dir``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

__all__ = ["REFS", "REFS_SOURCE", "gen_one", "build_one", "time_one",
           "family_record", "emit_records", "main"]

#: the reference C library's best spmv_l2 GF/s on the same matrices, by
#: family: (its label, GF/s).  Measured on the JAX round's host CPU (4
#: threads, AVX2, f64: its harness is f64-only), not on the card's host;
#: f32 families compare against the same f64 figure, the ``_f64`` ones in
#: the library's own type.
REFS = {
    "banded4m": ("reference SellCSigma x4, f64", 6.11),
    "clustered200k": ("reference SellCSigma x4, f64", 9.64),
    "uniform100k": ("reference Balanced x4, f64", 8.18),
    "powerlaw100k": ("reference Parallel x4, f64", 5.09),
    # webbase-shaped ultra-sparse; the reference measured on the identical
    # .mtx (baselines/reference_cpu_webbase1m.csv)
    "webbase1m": ("reference SellCSigma x4, f64", 2.84),
    "uniform100k_f64": ("reference Balanced x4, f64 (own dtype)", 8.18),
    "clustered200k_f64": ("reference SellCSigma x4, f64 (own dtype)", 9.64),
    "powerlaw100k_f64": ("reference Parallel x4, f64 (own dtype)", 5.09),
    "banded1m_f64": ("reference SellCSigma x4, f64 (own dtype)", 12.51),
}
REFS_SOURCE = ("the reference C library's best spmv_l2 GF/s, 4 threads, "
               "AVX2, f64, measured on the JAX round's host CPU "
               "(baselines/reference_cpu*.csv), not on the card's host")

#: the chained protocol: chains a sample, SpMVs a chain, samples a window
ITERS, K, REPEATS = 10, 32, 2
#: timing windows, and the seconds between them
WINDOWS, GAP_S = 2, 15
#: the compact line's limit: the whole line survives a 2,000-char tail
LINE_MAX = 1900
RECORD = "bench_torch_latest.json"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def gen_one(name: str):
    """The family's matrix: ``bench.py:_gen_one``'s generator call, sizes
    and seeds, on the port's ``io.generate``; ``_f64`` families take f64
    values drawn with seed 7 on the f32 pattern."""
    from ..io import generate
    from ..types import CsrMatrix

    def _to_f64(a, seed=7):
        vals = np.random.default_rng(seed).standard_normal(a.nnz)
        return CsrMatrix(a.m, a.n, a.rowptr, a.colidx, vals)

    if name == "banded4m":
        return generate.banded(4_000_000, 4_000_000, 4, dtype=np.float32,
                               seed=7)
    if name == "banded1m_f64":
        return _to_f64(generate.banded(1_000_000, 1_000_000, 4,
                                       dtype=np.float32, seed=7))
    if name.startswith("clustered200k"):
        a = generate.clustered(200_000, 200_000, 32, spread=512,
                               dtype=np.float32, seed=9)
        return _to_f64(a) if name.endswith("_f64") else a
    if name.startswith("uniform100k"):
        a = generate.random_uniform(100_000, 100_000, 40,
                                    dtype=np.float32, seed=42)
        return _to_f64(a) if name.endswith("_f64") else a
    if name == "webbase1m":
        return generate.webbase_like(1_000_000, 1_000_000, 3_100_000,
                                     dtype=np.float32, seed=11)
    a = generate.power_law(100_000, 100_000, 40 * 100_000,
                           dtype=np.float32, seed=2)
    return _to_f64(a) if name.endswith("_f64") else a


def build_one(name: str, a, device) -> dict:
    """The pre-deal of one family: ``create_handle(a, Method.AUTO)`` on
    ``device`` under ``predeal_profile``, and x from ``default_rng(0)`` in
    the matrix's type.  Returns the handle, x, nnz and the pre-deal's ms
    (whole and transfer)."""
    import torch
    from ..handle import create_handle
    from ..types import Method
    from ..utils.profiling import predeal_profile

    t0 = time.perf_counter()
    with predeal_profile() as laps:
        h = create_handle(a, method=Method.AUTO, device=device)
    predeal = round((time.perf_counter() - t0) * 1e3, 1)
    transfer = round(laps["transfer_s"] * 1e3, 1)
    print(f"# bench: {name} predeal {predeal:.0f} ms (transfer "
          f"{transfer:.0f} ms)", file=sys.stderr, flush=True)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(a.n)
                         .astype(np.asarray(a.vals).dtype)).to(h.device)
    return {"handle": h, "x": x, "nnz": a.nnz, "predeal_ms": predeal,
            "transfer_ms": transfer}


def time_one(h, x) -> dict:
    """One window's chained timing of handle ``h`` on ``x``
    (``time_spmv_chain``: inclusive, marginal and bubble seconds)."""
    from .timing import time_spmv_chain
    return time_spmv_chain(h._bound, x, iters=ITERS, k=K, repeats=REPEATS)


def family_record(name: str, built: dict, best: dict,
                  windows_ms=()) -> dict:
    """The full record's entry of a family that landed: ``bench.py``'s
    fields from its build and its best window, plus each window's
    inclusive ms."""
    ref_label, ref = REFS[name]
    nnz = built["nnz"]
    gflops = 2 * nnz / best["inclusive"] / 1e9
    h = built["handle"]
    tx = built["transfer_ms"]
    return {
        "gflops": round(gflops, 2),
        "gflops_marginal": round(2 * nnz / best["marginal"] / 1e9, 2),
        "ms": round(best["inclusive"] * 1e3, 3),
        "sync_bubble_ms": round(best["bubble"] * 1e3, 3),
        "nnz": nnz,
        "method": h.method_name,
        "value_mode": h.plan.get("value_mode"),
        "predeal_ms": built["predeal_ms"],
        "pack_ms": round(built["predeal_ms"] - tx, 1),
        "transfer_ms": tx,
        "ref_gflops": ref,
        "ref": ref_label,
        "vs_ref": round(gflops / ref, 2),
        "windows_ms": list(windows_ms),
    }


def _gpu_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e.__class__.__name__})"
    out = (res.stdout or res.stderr).strip().splitlines()
    return out[0] if out else f"exit {res.returncode}"


def emit_records(head_name, head, backend, names, configs, out_dir=None,
                 gpu=None) -> str:
    """Write the full record to ``out_dir/bench_torch_latest.json`` (by
    default ``chiprun_out/`` under the checkout) and print the compact line
    (returned for tests): per family g=gflops, vr=vs_ref, pk=pack_ms,
    tx=transfer_ms, or e=1 for a failed family."""
    if out_dir is None:
        out_dir = os.path.join(ROOT, "chiprun_out")
    path = os.path.join(out_dir, RECORD)
    rel = os.path.relpath(path, ROOT)
    full_name = path if rel.startswith("..") else rel
    full = {
        "metric": f"spmv_gflops_{head_name}",
        "value": head["gflops"],
        "unit": "GFLOP/s",
        "vs_baseline": head["vs_ref"],
        "backend": backend,
        "gpu": gpu,
        "configs": configs,
        "refs": REFS_SOURCE,
        "timing_protocol": "chained-k dependent-SpMV protocol "
                           "(spmv_tpu_torch/bench/timing.py): each step "
                           f"runs k={K} SpMVs, each fed the previous y "
                           "divided by a power of two (the renorm, four "
                           "launches); a sample is two CUDA events around "
                           f"{ITERS} steps, best of {REPEATS}; gflops = "
                           "2 nnz / (T(k)/k), the renorm and 1/k of a "
                           "step's cost included; gflops_marginal = "
                           "2 nnz / ((T(k)-T(1))/(k-1)); sync_bubble_ms = "
                           f"T(1) - marginal; best of {WINDOWS} windows "
                           f"{GAP_S} s apart, every family in turn within "
                           "a window",
    }
    try:
        os.makedirs(out_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(full, f, indent=1)
    except OSError:
        pass

    fam = {}
    for name in names:
        c = configs.get(name, {})
        if "gflops" in c:
            fam[name] = {"g": c["gflops"], "vr": c["vs_ref"],
                         "pk": round(c["pack_ms"]),
                         "tx": round(c["transfer_ms"])}
        else:
            fam[name] = {"e": 1}
    line = json.dumps({
        "metric": f"spmv_gflops_{head_name}",
        "value": head["gflops"],
        "unit": "GFLOP/s",
        "vs_baseline": head["vs_ref"],
        "backend": backend,
        "families": fam,
        "full": full_name,
    }, separators=(",", ":"))
    if len(line) > LINE_MAX:  # never past the tail window
        line = json.dumps({
            "metric": f"spmv_gflops_{head_name}", "value": head["gflops"],
            "unit": "GFLOP/s", "vs_baseline": head["vs_ref"],
            "backend": backend, "full": full_name,
        }, separators=(",", ":"))
    print(line)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="The port's headline SpMV benchmark: nine families, "
                    "AUTO plans, the chained protocol, one JSON line.")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu; never a fallback")
    ap.add_argument("--out-dir", default=None,
                    help="where the full record goes (default: "
                         "chiprun_out/ under the checkout)")
    args = ap.parse_args(argv)
    import torch
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        # no fallback: a CUDA device that is not there measures nothing
        print("bench_torch: no CUDA device was found (torch.cuda."
              "is_available() is false); pass --device cpu to run on the "
              "CPU", file=sys.stderr)
        return 2
    gpu = _gpu_line() if dev.type == "cuda" else None
    if gpu:
        print(f"# bench: {gpu}", file=sys.stderr, flush=True)

    # One matrix at a time: generate, build the handle (the measured
    # pre-deal), then drop the host CSR before the next.
    names = list(REFS)
    built, errors = {}, {}
    for name in names:
        try:
            print(f"# bench: building {name}", file=sys.stderr, flush=True)
            a = gen_one(name)
            built[name] = build_one(name, a, dev)
            del a
        except Exception:  # noqa: BLE001 — one family never ends the run
            errors[name] = traceback.format_exc(limit=3)
            built.pop(name, None)

    ok_names = [n for n in names if n in built]
    best = {name: None for name in ok_names}
    windows_ms = {name: [] for name in ok_names}
    for window in range(WINDOWS):
        for name in ok_names:
            b = built[name]
            try:
                r = time_one(b["handle"], b["x"])
            except Exception:  # noqa: BLE001
                errors[name] = traceback.format_exc(limit=3)
                continue
            windows_ms[name].append(r["inclusive"] * 1e3)
            print(f"# bench: w{window} {name} {r['inclusive'] * 1e3:.3f} ms",
                  file=sys.stderr, flush=True)
            if best[name] is None or r["inclusive"] < best[name]["inclusive"]:
                best[name] = r
        if window < WINDOWS - 1:
            time.sleep(GAP_S)

    configs = {}
    for name in names:
        ref_label, ref = REFS[name]
        if best.get(name) is None:
            configs[name] = {"error": errors.get(name, "timing failed"),
                             "ref_gflops": ref, "ref": ref_label}
            continue
        configs[name] = family_record(name, built[name], best[name],
                                      windows_ms[name])

    # headline: banded4m when it landed, else the best surviving family
    backend = dev.type
    head_name = "banded4m"
    if "gflops" not in configs.get(head_name, {}):
        landed = [n for n in names if "gflops" in configs.get(n, {})]
        if not landed:
            print(json.dumps({
                "metric": "spmv_f32_gflops_banded4m", "value": 0,
                "unit": "GFLOP/s", "vs_baseline": 0,
                "backend": backend, "error": "no config survived",
            }))
            return 1
        head_name = max(landed, key=lambda n: configs[n]["vs_ref"])
    emit_records(head_name, configs[head_name], backend, names, configs,
                 out_dir=args.out_dir, gpu=gpu)
    return 0
