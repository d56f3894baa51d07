"""Bytes-moved / roofline model (reference ``getB``/``getFLOP``, utils.h:11-19;
a copy of ``spmv_tpu/utils/perfmodel.py``, pinned by
``tests/test_torch_suite.py``).

The reference models SpMV traffic as ``(m+1+nnz)·sizeof(int) +
(2·nnz+m)·sizeof(val)`` (rowptr + colidx reads, val + x-gather reads, y
write) and FLOPs as ``2·nnz``; this module reproduces that model per format
so benchmark output can report bandwidth efficiency.
"""

from __future__ import annotations


__all__ = ["bytes_moved", "roofline_gflops", "FLOP_PER_NNZ"]

FLOP_PER_NNZ = 2


def bytes_moved(m: int, n: int, nnz: int, val_bytes: int = 4,
                idx_bytes: int = 4, fmt: str = "csr",
                pad_ratio: float = 1.0) -> int:
    """Traffic model per SpMV execution.

    ``csr``: the reference's model (utils.h:11-14).
    ``sell8w``: vals (f32) + int16 meta per padded slot + y write.
    ``dia``: diagonal data + x per diagonal + y write (ndiags via pad_ratio
    = ndiags·m/nnz).
    """
    if fmt == "csr":
        return (m + 1 + nnz) * idx_bytes + (2 * nnz + m) * val_bytes
    if fmt == "sell8w":
        padded = int(nnz * pad_ratio)
        return padded * (val_bytes + 2) + m * val_bytes
    if fmt == "dia":
        padded = int(nnz * pad_ratio)          # ndiags * m
        return padded * val_bytes + padded * val_bytes + m * val_bytes
    raise ValueError(f"unknown fmt {fmt!r}")


def roofline_gflops(m: int, n: int, nnz: int, bandwidth_gbs: float,
                    **kw) -> float:
    """Bandwidth-bound GFLOP/s ceiling for this matrix/format."""
    b = bytes_moved(m, n, nnz, **kw)
    return FLOP_PER_NNZ * nnz / (b / (bandwidth_gbs * 1e9)) / 1e9
