"""Pre-deal profiling: the host-pack vs device-transfer split of handle
creation (the port of ``spmv_tpu/utils/profiling.py``'s
``predeal_profile`` and ``dev_put``)."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["predeal_profile", "dev_put"]

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
