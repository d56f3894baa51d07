"""bfloat16 without ``ml_dtypes``: numpy bit operations, stored as uint16.

The JAX package keeps bf16 matrices and lossless-bf16 value streams as
``ml_dtypes.bfloat16`` arrays; the machine that runs the port has no
``ml_dtypes``.  A bf16 array here is a ``uint16`` array holding the top 16
bits of the float32 value: a bf16 ``CsrMatrix``'s values and the packs'
bf16 planes alike.  Torch sees it through :func:`as_torch` (a bit view, no
copy on the host); :func:`bits_of` takes a ``torch.bfloat16`` tensor, or
an ``ml_dtypes`` array where that package is installed, back to bits.
Code that reads values as numbers goes through :func:`as_float`, never
``astype``, which would read the bits as integers.
"""

from __future__ import annotations

import numpy as np

__all__ = ["from_f32", "to_f32", "is_lossless", "as_torch", "bits_of",
           "as_float", "round_f32", "is_bf16", "refuse"]


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


def bits_of(v) -> np.ndarray:
    """bf16 values → their uint16 bits: a ``torch.bfloat16`` tensor (moved
    to the host), or a numpy array whose ``dtype.name`` is "bfloat16"
    (``ml_dtypes``, never imported here)."""
    if hasattr(v, "dtype") and str(v.dtype) == "torch.bfloat16":
        import torch
        return v.detach().cpu().contiguous().view(torch.int16).numpy() \
            .view(np.uint16)
    a = np.ascontiguousarray(v)
    if a.dtype.name != "bfloat16":
        raise TypeError(f"not a bfloat16 array: {a.dtype}")
    return a.view(np.uint16)


def as_float(v) -> np.ndarray:
    """Values as numbers: bf16 bits (uint16) decoded to float32, any other
    array as it is."""
    a = np.asarray(v)
    return to_f32(a) if a.dtype == np.uint16 else a


def round_f32(v) -> np.ndarray:
    """Floats rounded to their nearest bf16 values, as float32: what
    ``v.astype(ml_dtypes.bfloat16)`` holds (an f64 array rounds through
    float32 first, as ``ml_dtypes`` does)."""
    return to_f32(from_f32(np.asarray(v, dtype=np.float32)))


def refuse(vals, what: str) -> None:
    """Raise ``ValueError`` when ``vals`` are bf16 bits: ``what`` takes
    f32 and f64 values only, as the JAX planner keeps bf16 matrices off
    its SELL and COO2 tile routes."""
    if np.asarray(vals).dtype == np.uint16:
        raise ValueError(f"{what} takes float32 or float64 values, not "
                         "bfloat16")


def is_bf16(dtype) -> bool:
    """Whether ``dtype`` is bfloat16: ``torch.bfloat16``, or a numpy or
    ``ml_dtypes`` type of that name."""
    name = getattr(dtype, "name", None) or getattr(dtype, "__name__", None)
    return str(dtype) == "torch.bfloat16" or name == "bfloat16"
