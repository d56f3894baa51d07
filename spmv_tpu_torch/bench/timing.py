"""Device timing (the port of ``spmv_tpu/bench/timing.py``).

The contract is the JAX package's: seconds per call of ``step`` chained
``iters`` times (each call consumes the previous output), after one warm
run; ``time_spmv`` and ``time_spmv_chain`` renormalise y between calls so
the chain stays finite, and time rectangular matrices by feeding back a
data-dependent scalar from y.  What the TPU runtime needed is not ported:
eager PyTorch neither dedupes repeated calls nor folds a chain, so there is
no ``fori_loop``, no ``closure_convert`` and no chained-dispatch fallback
for the remote compile service.

The device is the tensor's own.  On a CUDA tensor a sample is two CUDA
events on that device's current stream around the chain, and one
synchronise; on a CPU tensor it is ``time.perf_counter`` around the chain.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

__all__ = ["time_op", "time_op_samples", "time_spmv",
           "time_spmv_samples", "time_spmv_chain", "is_cuda_error",
           "synchronize"]

#: the exponent bits of an IEEE float, by its integer view's type
_EXP_MASK = {torch.float32: (torch.int32, 0x7F800000),
             torch.float64: (torch.int64, 0x7FF0000000000000)}


def is_cuda_error(e: BaseException) -> bool:
    """Whether ``e`` is an error of the card (``torch.AcceleratorError``,
    or a ``RuntimeError`` whose message names CUDA, as a kernel wrapper's
    failed launch does).  Such an error is sticky: every later call on the
    card fails too, so a sweep must not count it as one plan losing."""
    accel = getattr(torch, "AcceleratorError", None)
    return ((accel is not None and isinstance(e, accel))
            or (isinstance(e, RuntimeError) and "CUDA" in str(e)))


def synchronize(device: torch.device) -> None:
    """Wait for the card's work on ``device``; nothing on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_op_samples(step: Callable, x0: torch.Tensor, iters: int = 10,
                    repeats: int = 2) -> list:
    """Per-repeat seconds per call of ``step``, chained ``iters`` times
    from ``x0`` (x ← step(x)), after one warm call."""
    dev = x0.device
    step(x0)                                      # warm
    synchronize(dev)
    samples = []
    for _ in range(repeats):
        if dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            x = x0
            for _ in range(iters):
                x = step(x)
            end.record(stream)
            end.synchronize()
            samples.append(start.elapsed_time(end) / 1e3 / iters)
        else:
            t0 = time.perf_counter()
            x = x0
            for _ in range(iters):
                x = step(x)
            samples.append((time.perf_counter() - t0) / iters)
    return samples


def time_op(step: Callable, x0: torch.Tensor, iters: int = 10,
            repeats: int = 2) -> float:
    """Best seconds per call of ``step`` (x -> x-like, data-dependent)."""
    return min(time_op_samples(step, x0, iters=iters, repeats=repeats))


def _pow2_floor(y: torch.Tensor) -> torch.Tensor:
    """The largest power of two ≤ max(max|y|, 1e-30), as a 0-dim tensor:
    the max's exponent bits, so a division by it is exact.  Four launches
    with the division (norm, clamp, mask, divide), where the JAX package's
    ``exp2(-ceil(log2(...)))`` would take eight."""
    itype, mask = _EXP_MASK[y.dtype]
    top = torch.linalg.vector_norm(y, float("inf")).clamp_min(1e-30)
    return (top.view(itype) & mask).view(y.dtype)


def _renorm(y: torch.Tensor) -> torch.Tensor:
    return y / _pow2_floor(y)


def _steps(spmv_fn: Callable, x0: torch.Tensor, k: int) -> Callable:
    """k dependent SpMVs a call: square matrices carry the renormalised y
    as the next x; rectangular ones keep x and divide it by a power of two
    taken from y (unfoldable, and x stays finite)."""
    rect = spmv_fn(x0).shape != x0.shape
    if rect:
        def step(x):
            for _ in range(k):
                x = x / _pow2_floor(spmv_fn(x))
            return x
        return step

    def step(x):
        for _ in range(k):
            x = _renorm(spmv_fn(x))
        return x
    return step


def time_spmv(spmv_fn: Callable, x0: torch.Tensor, iters: int = 10,
              repeats: int = 3) -> float:
    """Best seconds per y = A@x, chained through the renormalisation."""
    return time_op(_steps(spmv_fn, x0, 1), x0, iters=iters, repeats=repeats)


def time_spmv_chain(spmv_fn: Callable, x0: torch.Tensor, iters: int = 10,
                    k: int = 8, repeats: int = 2) -> dict:
    """Chained-k protocol: k dependent SpMVs a step.

    * ``inclusive`` — T(k)/k: per-SpMV seconds with 1/k of the per-step
      cost (the reference's GFlops column);
    * ``marginal`` — (T(k) − T(1))/(k−1): the steady per-SpMV cost (the
      reference's GFlops_fastest role);
    * ``bubble`` — T(1) − marginal: what a step costs beyond its SpMV.

    The renormalisation between SpMVs is in every term.
    """
    t_k = min(time_op_samples(_steps(spmv_fn, x0, k), x0, iters=iters,
                              repeats=repeats))
    t_1 = min(time_op_samples(_steps(spmv_fn, x0, 1), x0, iters=iters,
                              repeats=repeats))
    marginal = (t_k - t_1) / max(k - 1, 1)
    if marginal <= 0.05 * t_k / k:
        # noise regime (T(k) ≈ T(1)): a near-zero difference would report
        # a fantasy "fastest" number, so fall back to the inclusive rate
        marginal = t_k / k
    return {
        "inclusive": t_k / k,
        "marginal": marginal,
        "bubble": max(t_1 - marginal, 0.0),
        "t_1": t_1,
        "t_k": t_k,
        "k": k,
    }


def time_spmv_samples(spmv_fn: Callable, x0: torch.Tensor, iters: int = 10,
                      repeats: int = 3) -> list:
    """All per-repeat samples of :func:`time_spmv` (for avg + best)."""
    return time_op_samples(_steps(spmv_fn, x0, 1), x0, iters=iters,
                           repeats=repeats)
