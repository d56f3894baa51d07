"""Utilities: the bandwidth model, profiling (pre-deal split, traces,
timers)."""

from .perfmodel import bytes_moved, roofline_gflops
from .profiling import (Stopwatch, dev_asarray, dev_put, predeal_profile,
                        trace)

__all__ = ["bytes_moved", "roofline_gflops", "trace", "Stopwatch",
           "predeal_profile", "dev_put", "dev_asarray"]
