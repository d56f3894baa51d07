"""bfloat16 without ``ml_dtypes``: numpy bit operations, stored as uint16.

The JAX package keeps lossless-bf16 value streams as ``ml_dtypes.bfloat16``
arrays; the machine that runs the port has no ``ml_dtypes``.  A bf16 array
here is a ``uint16`` array holding the top 16 bits of the float32 value.
Torch sees it through :func:`as_torch` (a bit view, no copy on the host).
"""

from __future__ import annotations

import numpy as np

__all__ = ["from_f32", "to_f32", "is_lossless", "as_torch"]


def from_f32(v) -> np.ndarray:
    """float32 → bf16 bits, round to nearest even (``ml_dtypes`` rounding);
    a NaN becomes the quiet NaN of its sign."""
    u = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    lsb = (u >> np.uint32(16)) & np.uint32(1)
    out = ((u + np.uint32(0x7FFF) + lsb) >> np.uint32(16)).astype(np.uint16)
    nan = np.isnan(u.view(np.float32))
    if nan.any():
        out[nan] = np.where(u[nan] >> np.uint32(31), 0xFFC0, 0x7FC0)
    return out


def to_f32(b) -> np.ndarray:
    """bf16 bits → float32 (exact)."""
    return (np.asarray(b, dtype=np.uint16).astype(np.uint32)
            << np.uint32(16)).view(np.float32)


def is_lossless(v) -> bool:
    """True when every value round-trips bf16 exactly: the low 16 bits of
    each float32 are zero."""
    u = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    return not bool((u & np.uint32(0xFFFF)).any())


def as_torch(b):
    """bf16 bits (uint16 numpy) → a ``torch.bfloat16`` tensor on the CPU."""
    import torch
    return torch.from_numpy(
        np.ascontiguousarray(b, dtype=np.uint16).view(np.int16)
    ).view(torch.bfloat16)
