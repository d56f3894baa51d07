"""The traced part of a ``--trace 1`` run: two ``torch.profiler`` segments
at the start of the window, and their reduction to the numbers the
per-layer metrics read.

* ``busy``: the card's activity alone, with no host op recorded, since
  recording every host op slows the host (a CG set 2x on the H100) and
  so inflates the idle share.  ``busy`` is the union of the device's
  activities (kernels, copies, fills); the window is two CUDA events
  around the segment.  The idle share is ``1 − busy / window`` as
  ``chip_smoke.py`` takes it (``profile_calls``, ``chip_smoke.py:1344``;
  ``solve_record``, ``:2298``).
* ``ranges``: the host's ops too.  The harness marks ``SOLVE`` around each
  unit and ``SPMV`` around each call into the handle with
  ``record_function``.  A device activity belongs to a range when the host
  call that launched it (matched by the profiler's correlation id) lies
  inside the range.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from typing import Dict, List, Optional

import torch

SOLVE = "spmvbench.unit"
SPMV = "spmvbench.spmv"

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_HOST_CATS = ("cpu_op", "user_annotation")


class Segment:
    """A profiled stretch of units, ``busy`` or ``ranges``; ``finish()``
    stops it and returns its numbers (seconds)."""

    def __init__(self, stage: str, device):
        from torch.profiler import ProfilerActivity, profile
        self.stage = stage
        self.cuda = torch.device(device).type == "cuda"
        activities = []
        if stage == "ranges" or not self.cuda:
            activities.append(ProfilerActivity.CPU)
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(device)
            self.ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
        self.prof = profile(activities=activities)
        self.prof.start()
        self.t0 = time.perf_counter()
        if self.cuda:
            self.ev[0].record()

    def finish(self) -> Optional[Dict]:
        if self.cuda:
            self.ev[1].record()
            self.ev[1].synchronize()
            window = self.ev[0].elapsed_time(self.ev[1]) / 1e3
        else:
            window = time.perf_counter() - self.t0
        self.prof.stop()
        if self.stage == "ranges":
            return reduce(self.prof)
        dev = [(e["ts"], e["ts"] + e["dur"]) for e in _events(self.prof)
               if e.get("cat") in _DEVICE_CATS and e.get("ph") == "X"]
        lo = min((s for s, _e in dev), default=0.0)
        hi = max((e for _s, e in dev), default=0.0)
        return {"window_s": window, "busy_s": _union(dev, lo, hi) / 1e6,
                "device_events": len(dev)}


def ranged(fn):
    """``fn`` with each call inside an ``SPMV`` range."""
    def call(x):
        with torch.profiler.record_function(SPMV):
            return fn(x)
    return call


def unit_range():
    return torch.profiler.record_function(SOLVE)


def _events(prof) -> List[dict]:
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])


def _union(intervals, lo, hi) -> float:
    total, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


class _Spans:
    """Sorted, non-overlapping ranges of one name; ``index(t)`` is the
    range holding t, or None."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s for s, _e in self.spans]

    def index(self, t) -> Optional[int]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.spans[i][1]:
            return i
        return None


class _HostOps:
    """The innermost host op or range open at a time on one thread."""

    def __init__(self, events, tid):
        ops = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                     for e in events
                     if e.get("cat") in _HOST_CATS and e.get("tid") == tid
                     and e.get("ph") == "X")
        self.ops = ops
        self.starts = [s for s, _e, _n in ops]

    def at(self, t, look=4000) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(i - look, -1), -1):
            s, e, name = self.ops[j]
            if s <= t <= e:
                return name
        return "no host op"


def reduce(prof) -> Optional[Dict]:
    """The ranges segment's numbers, or None when it holds no traced unit.
    Times are seconds; ``window_s`` runs from the first unit's start to the
    last one's end."""
    events = _events(prof)
    ann = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("ph") == "X"]
    units = [e for e in ann if e["name"] == SOLVE]
    if not units:
        return None
    solves = _Spans((e["ts"], e["ts"] + e["dur"]) for e in units)
    spmvs = _Spans((e["ts"], e["ts"] + e["dur"]) for e in ann
                   if e["name"] == SPMV)
    lo, hi = solves.spans[0][0], solves.spans[-1][1]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in _LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS
           and e.get("ph") == "X" and e["ts"] + e["dur"] > lo
           and e["ts"] < hi]
    host = _HostOps(events, units[0].get("tid"))
    in_spmv = in_spmv_foreign = outside_spmv = 0.0
    unlaunched = 0
    recorded = set()
    ops: Dict[str, float] = {}
    for e in dev:
        ops[e["name"]] = ops.get(e["name"], 0.0) + e["dur"]
        src = launch.get(e.get("args", {}).get("correlation"))
        if src is None:
            unlaunched += 1
            continue
        t = src["ts"]
        k = spmvs.index(t)
        if k is not None:
            recorded.add(k)
            in_spmv += e["dur"]
            if "spmv::" not in e["name"]:
                in_spmv_foreign += e["dur"]
        elif solves.index(t) is not None:
            outside_spmv += e["dur"]
    # idle gaps, each named by the host op that launched the activity
    # ending it (the tail gap: the host op open at the window's end)
    gaps: Dict[str, float] = {}
    end = lo
    for e in sorted(dev, key=lambda e: e["ts"]):
        if e["ts"] > end:
            src = launch.get(e.get("args", {}).get("correlation"))
            name = host.at(src["ts"]) if src is not None else "unknown"
            gaps[name] = gaps.get(name, 0.0) + (e["ts"] - end)
        end = max(end, e["ts"] + e["dur"])
    if hi > end:
        name = host.at(end)
        gaps[name] = gaps.get(name, 0.0) + (hi - end)

    def top(d):
        return [[k[:160], v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"window_s": (hi - lo) / 1e6, "units": len(solves.spans),
            "products": len(spmvs.spans), "recorded_products": len(recorded),
            "spmv_device_s": in_spmv / 1e6,
            "spmv_foreign_s": in_spmv_foreign / 1e6,
            "outside_spmv_s": outside_spmv / 1e6,
            "device_events": len(dev), "unlaunched_events": unlaunched,
            "breakdown": {"device_ops": top(ops), "idle_gaps": top(gaps)}}
