"""Benchmark harness: device timing + the reference-schema CSV suite."""

from .timing import time_op, time_spmv

__all__ = ["time_op", "time_spmv"]
