"""Profiling inside the port (the port of ``spmv_tpu/utils/profiling.py``,
grown): spans at the port's layer boundaries, the kernels' launch counts,
the pre-deal's record, and a torch.profiler Chrome trace (``trace``).

**Spans.**  ``with span(name):`` bounds one stretch of the host's work.  A
span is live only while a torch profiler records
(``torch.autograd.profiler._is_profiler_enabled``) or a
:func:`predeal_profile` record is open (:data:`record`); otherwise
``span`` makes one check and returns a shared context that does nothing
(no clock read, no allocation, no name formatted).  The sites a product
passes make that check themselves, inline, and enter no context and call
no extra function when it fails: a Python call or ``with`` costs a tenth
of a µs on the card's host, and a product passes up to six sites.  Live,
a span opens a profiler range of its name (``record_function``; where
torch has it, its C++ form, which costs a seventh as much), so it lies on
the profiler's clock beside CUPTI's kernels and copies and nests in the
Chrome trace, and it adds its count, inclusive host seconds and self
seconds (inclusive less its live children) to one table in memory, keyed
by name: :func:`spans`, :func:`reset_spans`.  A span opened directly
inside one of the same name merges into it (``spmv()`` opens
``spmv.product`` around its checks, then calls the handle's bound
closure, which opens it for callers that bypass ``spmv()``).

The port's spans, fixed names:

* ``spmv.product``: the host's whole side of one product (``handle.py``);
* ``spmv.kernel.<kernel>``: one port kernel's call, allocation, argument
  packing and launch, or its plain version on the CPU (``ops/``);
  ``<kernel>`` is the kernel's name in :data:`launches`;
* ``spmv.glue.fold``, ``.rest``, ``.xext``, ``.stripes``, ``.perm``: the
  handle's glue between the kernels (``handle.py``);
* ``solver.solve``, ``solver.read``: one solve, one host read of the
  card's state (``solvers.py``);
* ``predeal.inspect``, ``.prepare``, ``.build``, ``.place``:
  ``create_handle``'s stages, whose seconds :func:`predeal_profile`'s
  record also holds.

**Counters.**  :data:`launches` counts every launch of a port kernel by
kernel name; it is always on (one dict increment a launch).  It is a
``defaultdict(int)``, not a ``Counter``: a ``Counter`` defines
``__delitem__`` in Python, so its item assignment runs through Python
and costs three to four times the module global it replaced.

Nothing here writes to disk but :func:`trace`.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["trace", "predeal_profile", "dev_put", "dev_asarray", "span",
           "spanned", "live", "opening", "spans", "reset_spans", "launches",
           "record", "PREDEAL_STAGES"]

#: kernel launches by kernel name (``dia``, ``dia_f64``, ``sell_row``, ...,
#: the probe kernels); always on, cleared by callers that count
launches: collections.defaultdict = collections.defaultdict(int)

#: the open pre-deal record, or None
record: Optional[Dict[str, float]] = None

#: the pre-deal's stage spans → their key in the record
PREDEAL_STAGES = {"predeal.inspect": "inspect_s",
                  "predeal.prepare": "prepare_s",
                  "predeal.build": "build_s",
                  "predeal.place": "place_s"}

#: span name → [count, inclusive s, self s]
_TABLE: Dict[str, List[float]] = {}
_TABLE_LOCK = threading.Lock()
#: each thread's open live spans, innermost last
_OPEN = threading.local()

_FAST_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)


class _Off:
    """The span of tracing off: enters and leaves, nothing else."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def live() -> bool:
    """Whether spans record: a torch profiler records, or a pre-deal
    record is open.  Hot sites test the same two flags inline."""
    return _autograd_profiler._is_profiler_enabled or record is not None


def opening(name: str) -> Optional["_Span"]:
    """The live span to open under ``name``, or None where spans are off or
    the innermost live span open on this thread already is ``name``.  A
    site that, tracing on, opens its span and runs itself again inside it
    (so that tracing off costs it no extra call) opens this one."""
    if not (_autograd_profiler._is_profiler_enabled or record is not None):
        return None
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    elif stack and stack[-1].name == name:
        return None
    return _Span(name, stack)


class _Span:
    __slots__ = ("name", "stack", "range", "t0", "child")

    def __init__(self, name: str, stack: list):
        self.name, self.stack = name, stack

    def __enter__(self):
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = (_FAST_RANGE(self.name) if _FAST_RANGE is not None
                          else torch.profiler.record_function(self.name))
            self.range.__enter__()
        self.child = 0.0
        self.stack.append(self)
        self.t0 = time.perf_counter()
        return None

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.stack:
            self.stack[-1].child += dt
        with _TABLE_LOCK:
            row = _TABLE.get(self.name)
            if row is None:
                row = _TABLE[self.name] = [0, 0.0, 0.0]
            row[0] += 1
            row[1] += dt
            row[2] += dt - self.child
        key = PREDEAL_STAGES.get(self.name)
        if key is not None and record is not None:
            record[key] += dt
        return False


def span(name: str):
    """A context manager bounding one stretch of the host's work under
    ``name`` (see the module's docstring); with tracing off, or directly
    inside a span of the same name, a shared context that does nothing."""
    return opening(name) or _OFF


def spanned(name: str, fn: Callable) -> Callable:
    """``fn`` with each call inside ``span(name)`` (a site a product passes
    calls it only while spans are live, and ``fn`` itself otherwise)."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return call


def spans() -> Dict[str, Dict[str, float]]:
    """A copy of the span table: name → ``count``, ``inclusive_s`` and
    ``self_s`` (inclusive less the live spans opened directly inside)."""
    with _TABLE_LOCK:
        return {k: {"count": int(c), "inclusive_s": i, "self_s": s}
                for k, (c, i, s) in _TABLE.items()}


def reset_spans() -> None:
    """Empty the span table."""
    with _TABLE_LOCK:
        _TABLE.clear()


@contextlib.contextmanager
def predeal_profile():
    """Record handle creation: its stages and its transfers.

    Yields one dict, updated in place while the block runs: ``inspect_s``,
    ``prepare_s``, ``build_s`` and ``place_s`` (the wall seconds of
    ``create_handle``'s stage spans, :data:`PREDEAL_STAGES`; 0.0 for a
    stage that did not run), ``transfer_s`` (wall seconds spent in device
    transfers, each one synchronised with the card inside the profile,
    within ``place_s``) and ``bytes`` (plan bytes shipped).  Spans are live
    while it is open, so the stages also reach :func:`spans`.  The
    synchronisation serialises transfers against host work, so use it for
    measurement, not on hot paths."""
    global record
    prev = record
    record = {"transfer_s": 0.0, "bytes": 0,
              **dict.fromkeys(PREDEAL_STAGES.values(), 0.0)}
    try:
        yield record
    finally:
        record = prev


def dev_put(x, device) -> torch.Tensor:
    """A numpy array or CPU tensor onto ``device``; instrumented when a
    predeal_profile is active."""
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x)
        t = torch.from_numpy(x if x.flags.writeable else x.copy())
    else:
        t = x
    dev = torch.device(device)
    rec = record
    if rec is None:
        return t.to(dev)
    t0 = time.perf_counter()
    r = t.to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    rec["transfer_s"] += time.perf_counter() - t0
    rec["bytes"] += r.numel() * r.element_size()
    return r


def dev_asarray(x, device) -> Optional[torch.Tensor]:
    """:func:`dev_put`, passing None through (the JAX package's
    ``dev_asarray``, for optional planes)."""
    return None if x is None else dev_put(x, device)


@contextlib.contextmanager
def trace(logdir: str):
    """Record a torch.profiler trace of the block (host activity, and the
    card's where CUDA is available) and write it to ``logdir/trace.json``
    as a Chrome trace (Perfetto, chrome://tracing), the port's spans
    nested in it.  Yields the profiler, whose ``key_averages()`` sums
    device time by kernel."""
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
