"""The harness: finds a cell's files by name, runs its set-up and its
window, takes the end-to-end metrics, reads the per-layer ones from the
traced run, and decides ``correct`` against the plain reference.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own under the harness's root:
``configs/<config>.json`` (named by ``BENCHMARK.json``),
``generators/<generator>.py``, ``traffic/<traffic>.json``,
``loops/<loop>.py``, ``limits/<cell>.json`` and ``metrics/<metric>.py``.
The end-to-end arithmetic is here (``E2E``).
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import random
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.abspath(__file__))

#: top-level module names that may not be loaded in a run's process: JAX,
#: and the JAX package (the port's name begins with it, so names are
#: compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "spmv_tpu")


def by_name(entries: List[dict], name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no entry named {name!r}")


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load(root: str, kind: str, name: str):
    """The module ``<root>/<kind>/<name>.py``; for a name with a suffix
    after a dot and no file of its own, the module of the name before the
    dot (``metrics/idle_share.py`` reads ``idle_share.chain``)."""
    path = os.path.join(root, kind, name + ".py")
    if not os.path.isfile(path):
        path = os.path.join(root, kind, name.split(".")[0] + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    modname = "spmvbench_" + "".join(c if c.isalnum() else "_"
                                     for c in f"{kind}_{name}")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


# -- end-to-end arithmetic ---------------------------------------------------

def quantile(values: List[float], q: float) -> float:
    """The nearest-rank q-quantile: the smallest value with at least a
    share q of all values at or below it."""
    s = sorted(values)
    return s[max(math.ceil(q * len(s)), 1) - 1]


def least_bytes(m: int, n: int, nnz: int, value_bytes: int) -> int:
    """The least bytes one product moves: each value once in the
    configuration's dtype, x once and y once, no index bytes (a structured
    format may drop them)."""
    return (nnz + n + m) * value_bytes


#: NVIDIA H100 SXM5 80GB, NVIDIA's data sheet: HBM3 at 3.35 TB/s, at the
#: card's full power limit of 700 W (each run prints the card's limit)
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def roofline_share(rec: dict) -> Optional[float]:
    """A product's share (%) of its bandwidth roofline: the least time the
    card could take for one product (``least_bytes`` over the published
    peak) over the device time a product inside the calls into the
    handle; None where the trace or the card's peak is missing."""
    t, peak = rec["trace"], rec["peak_bytes_per_s"]
    if not t or not peak or not t["recorded_products"]:
        return None
    per_product = t["spmv_device_s"] / t["recorded_products"]
    return 100.0 * (rec["least_bytes"] / peak) / per_product


#: end-to-end metrics: name → the window's number
E2E: Dict[str, Callable[[dict], float]] = {
    "solve_ms": lambda w: w["window_s"] / w["units"] * 1e3,
    "solve_ms_p95": lambda w: quantile(w["unit_s"], 0.95) * 1e3,
    "spmv_gflops": lambda w: 2 * w["nnz"] * w["products"]
    / w["window_s"] / 1e9,
    "setup_s": lambda w: w["setup_s"],
}


def applies(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


class Reservoir:
    """A uniform sample of ``k`` items from a stream of unknown length,
    drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = k, random.Random(seed), 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def cell_files(bench: dict, workload: str, base: Optional[str] = None,
               root: str = ROOT) -> SimpleNamespace:
    """A cell's files, found by name: its configuration (``cfg``), traffic
    mix (``traffic``), limits (``limits``), generator (``gen``) and loop
    (``loop``) modules.  ``base`` is the checkout's root (by default the
    harness's parent), which ``BENCHMARK.json``'s paths start from."""
    base = base if base is not None else os.path.dirname(root)
    cell = by_name(bench["workloads"], workload)
    cfg = read_json(os.path.join(
        base, by_name(bench["configs"], cell["config"])["file"]))
    traffic = read_json(os.path.join(root, "traffic",
                                     cell["traffic"] + ".json"))
    return SimpleNamespace(
        cfg=cfg, traffic=traffic,
        limits=read_json(os.path.join(root, "limits", workload + ".json")),
        gen=load(root, "generators", cfg["generator"]),
        loop=load(root, "loops", traffic["loop"]))


def set_up(c: SimpleNamespace, seed: int, device: str,
           profile: bool = False) -> SimpleNamespace:
    """A cell's inputs and handle, as every run makes them: the generator's
    arrays from the seed, then one ``create_handle`` (AUTO), timed to a
    synchronise; under ``predeal_profile`` where ``profile`` is set.
    Returns ``a`` (the arrays), ``mat``, ``h``, ``gen_s``, ``predeal_s`` and
    ``laps`` (``predeal_profile``'s numbers, or empty)."""
    import torch
    import spmv_tpu_torch as port
    from spmv_tpu_torch.utils.profiling import predeal_profile

    t0 = time.perf_counter()
    a = c.gen.generate(c.cfg, seed, device)
    if torch.device(device).type == "cuda":
        # the peak is the program's: the generator's scratch is not
        _sync(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    mat = port.CsrMatrix(a["m"], a["n"], a["rowptr"], a["colidx"],
                         a["vals"])
    gen_s = time.perf_counter() - t0
    laps = {}
    with (predeal_profile() if profile else contextlib.nullcontext()) as p:
        t0 = time.perf_counter()
        h = port.create_handle(mat, port.Method.AUTO, device=device)
        _sync(device)
        predeal_s = time.perf_counter() - t0
        if p is not None:
            laps = dict(p)
    return SimpleNamespace(a=a, mat=mat, h=h, gen_s=gen_s,
                           predeal_s=predeal_s, laps=laps)


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             base: Optional[str] = None, root: str = ROOT,
             log=sys.stderr) -> dict:
    """One run of one cell.  Returns the result line's object, its
    ``checks`` last."""
    import torch
    import spmv_tpu_torch as port
    from spmv_tpu_torch import solvers
    from spmvbench import devtrace
    from spmvbench.reference import plain

    c = cell_files(bench, workload, base, root)
    cfg, traffic, limits = c.cfg, c.traffic, c.limits
    readers = {m["name"]: load(root, "metrics", m["name"])
               for m in bench["per_layer"] if trace and applies(m, workload)}

    inputs = set_up(c, seed, device, profile=trace)
    a, h = inputs.a, inputs.h
    print(f"route: {h!r}", file=log)
    t0 = time.perf_counter()
    loop = c.loop.make(port, h, a, cfg, traffic, seed, device)
    drain = getattr(loop, "drain", lambda: True)
    for _ in range(traffic["warm_units"]):
        loop.unit(None)
    drain()
    _sync(device)
    warm_s = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start

    # the window; a traced run then profiles two segments of
    # ``traced_units`` each: the card's activity alone (busy time), then the
    # host's ops and ranges beside it (what runs where).  The window comes
    # first, since a profiler slows the host even after it stops.
    sample = Reservoir(traffic["samples"], seed)
    syncs0 = solvers.host_syncs
    attempted = failed = 0
    segments: Dict[str, dict] = {}
    stages = [(None, 0)]
    if trace:
        stages += [("busy", traffic["traced_units"]),
                   ("ranges", traffic["traced_units"])]
    for stage, count in stages:
        seg = devtrace.Segment(stage, device) if stage else None
        times: List[float] = []
        products = 0
        t_w0 = t = time.perf_counter()
        while True:
            if stage == "ranges":
                with devtrace.unit_range():
                    n, ok, item = loop.unit(devtrace.ranged)
            else:
                n, ok, item = loop.unit(None)
            t_end = time.perf_counter()
            times.append(t_end - t)
            t = t_end
            products += n
            attempted += 1
            failed += not ok
            sample.offer(item)
            if len(times) == count or (not stage and t - t_w0 >= seconds):
                break
        # a loop that reads its results late: nothing more is sent, all
        # that was sent is waited for and counts, and the clock is read
        # after that wait
        failed += not drain()
        t = time.perf_counter()
        times[-1] += t - t_end
        if seg is not None:
            got = seg.finish()
            segments[stage] = dict(got, units=len(times)) if got else None
        else:
            unit_s, window_products, window_s = times, products, t - t_w0
    host_syncs = solvers.host_syncs - syncs0

    kind = "cpu"
    peak = 0
    if torch.device(device).type == "cuda":
        _sync(device)
        kind = torch.cuda.get_device_name(device)
        peak = torch.cuda.max_memory_allocated(device)
    route = repr(h)
    nnz = h.nnz
    loop.release()
    del h
    inputs.h = inputs.mat = None
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    # correct: the sampled units against the plain reference, in f64
    ref = plain.Csr(a, torch.float64, device)
    gaps: Dict[str, float] = {}
    bad_units = 0
    for item in sample.items:
        got = loop.gaps(item, loop.reference(ref, item))
        over = False
        for k, v in got.items():
            gaps[k] = max(gaps.get(k, 0.0), v) if math.isfinite(v) \
                else math.inf
            over |= not v <= limits[k]
        bad_units += over
    del ref
    checks = {k: {"value": gaps.get(k, math.inf), "limit": lim}
              for k, lim in limits.items()}
    correct = (failed == 0 and bool(sample.items)
               and all(c["value"] <= c["limit"] for c in checks.values()))

    window = {"window_s": window_s, "units": len(unit_s), "unit_s": unit_s,
              "products": window_products, "nnz": nnz,
              "predeal_s": inputs.predeal_s, "setup_s": setup_s}
    metrics = {}
    if not trace:
        for m in bench["end_to_end"]:
            if applies(m, workload):
                metrics[m["name"]] = {"value": E2E[m["name"]](window),
                                      "unit": m["unit"]}
    else:
        value_bytes = torch.empty((), dtype=getattr(torch, cfg["dtype"])) \
            .element_size()
        rec = {"predeal": {"total_s": inputs.predeal_s, **inputs.laps},
               "host_syncs": host_syncs, "attempted": attempted,
               "window": window,
               "busy": segments.get("busy"),
               "trace": segments.get("ranges"),
               "least_bytes": least_bytes(a["m"], a["n"], nnz, value_bytes),
               "peak_bytes_per_s": PEAK_BYTES_PER_S.get(kind)}
        for m in bench["per_layer"]:
            if m["name"] in readers:
                v = readers[m["name"]].read(rec)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    bad = forbidden_modules()
    if bad:
        raise SystemExit("modules of JAX or the JAX package were loaded: "
                         + ", ".join(bad))
    dev = {"platform": "gpu" if kind != "cpu" else "cpu", "kind": kind,
           "count": 1 if kind != "cpu" else 0, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": attempted,
           "failed": failed + bad_units, "metrics": metrics, "device": dev}
    if segments.get("busy"):
        dev["busy_s"] = segments["busy"]["busy_s"]
        dev["window_s"] = segments["busy"]["window_s"]
    if segments.get("ranges"):
        out["breakdown"] = segments["ranges"].pop("breakdown")
    for stage, rec in segments.items():
        print(f"trace {stage}: {json.dumps(rec)}", file=log)
    print(f"window: {len(unit_s)} units, {window_products} products, "
          f"{window_s:.6f} s, failed {failed}, host reads {host_syncs}, "
          f"setup {setup_s:.6f} s (generate {inputs.gen_s:.6f}, predeal "
          f"{inputs.predeal_s:.6f}, warm {warm_s:.6f}), "
          f"sampled {len(sample.items)}, {route}, "
          f"gpu {power_limit() if kind != 'cpu' else 'none'}", file=log)
    # the window's units a second, to tell a drift from a few slow units
    ends, per_s = 0.0, {}
    for u in unit_s:
        ends += u
        per_s.setdefault(int(ends), []).append(u)
    print("unit ms: p50 %.6f p95 %.6f max %.6f; mean by second: %s" % (
        quantile(unit_s, 0.5) * 1e3, quantile(unit_s, 0.95) * 1e3,
        max(unit_s) * 1e3, " ".join(
            "%.4f" % (sum(v) / len(v) * 1e3) for _k, v in sorted(
                per_s.items()))), file=log)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=log)
    out["checks"] = checks
    return out
