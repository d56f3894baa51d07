"""Profiling hooks (the port of ``spmv_tpu/utils/profiling.py``): the
pre-deal's host-pack vs device-transfer split (``predeal_profile``,
``dev_put``, ``dev_asarray``), a torch.profiler trace (``trace``) and the
reference's paired wall timers (``Stopwatch``)."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["trace", "Stopwatch", "predeal_profile", "dev_put", "dev_asarray"]

#: active predeal profile record (None = profiling off, zero overhead)
_PREDEAL_LAPS: Optional[Dict[str, float]] = None


@contextlib.contextmanager
def predeal_profile():
    """Record handle creation's host-pack vs device-transfer split.

    Yields a dict updated in place: ``transfer_s`` (wall seconds spent in
    device transfers, each one synchronised with the card inside the
    profile) and ``bytes`` (plan bytes shipped).  Pack time is the caller's
    total minus ``transfer_s``.  The synchronisation serialises transfers
    against host work, so use it for measurement, not on hot paths."""
    global _PREDEAL_LAPS
    prev = _PREDEAL_LAPS
    _PREDEAL_LAPS = {"transfer_s": 0.0, "bytes": 0}
    try:
        yield _PREDEAL_LAPS
    finally:
        _PREDEAL_LAPS = prev


def dev_put(x, device) -> torch.Tensor:
    """A numpy array or CPU tensor onto ``device``; instrumented when a
    predeal_profile is active."""
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x)
        t = torch.from_numpy(x if x.flags.writeable else x.copy())
    else:
        t = x
    dev = torch.device(device)
    if _PREDEAL_LAPS is None:
        return t.to(dev)
    t0 = time.perf_counter()
    r = t.to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    _PREDEAL_LAPS["transfer_s"] += time.perf_counter() - t0
    _PREDEAL_LAPS["bytes"] += r.numel() * r.element_size()
    return r


def dev_asarray(x, device) -> Optional[torch.Tensor]:
    """:func:`dev_put`, passing None through (the JAX package's
    ``dev_asarray``, for optional planes)."""
    return None if x is None else dev_put(x, device)


@contextlib.contextmanager
def trace(logdir: str):
    """Record a torch.profiler trace of the block (host activity, and the
    card's where CUDA is available) and write it to ``logdir/trace.json``
    as a Chrome trace (Perfetto, chrome://tracing).  Yields the profiler,
    whose ``key_averages()`` sums device time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Stopwatch:
    """Reference-style paired wall timers (test_spmv.c:89-124).  A lap
    around asynchronous CUDA work measures its enqueue unless the block
    synchronises."""

    def __init__(self):
        self.laps = {}

    @contextlib.contextmanager
    def lap(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.laps[name] = self.laps.get(name, 0.0) + \
                (time.perf_counter() - t0)

    def report(self) -> str:
        return ", ".join(f"{k}={v*1e3:.2f}ms" for k, v in self.laps.items())
