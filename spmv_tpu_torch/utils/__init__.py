"""Utilities: the bandwidth model, profiling (spans, launch counts, the
pre-deal's record, traces)."""

from .perfmodel import bytes_moved, roofline_gflops
from .profiling import (dev_asarray, dev_put, launches, predeal_profile,
                        reset_spans, span, spans, trace)

__all__ = ["bytes_moved", "roofline_gflops", "trace", "predeal_profile",
           "dev_put", "dev_asarray", "span", "spans", "reset_spans",
           "launches"]
