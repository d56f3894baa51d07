"""The two-pass COO2 plan (Method.CSR5): pass 1 is the kernel
``csrc/coo2.cu`` and its plain version; pass 2 is the SELL row-mode kernel
in its binary mode (``ops/sell.py``) over the product stream.

Pass 1 replaces ``spmv_tpu/ops/pallas_coo2.py::_make_pass1_kernel`` (K8):
``out[t, i, l] = vals[t, i, l] · x[1024·w_t + 128·s + r]``, r read at the
slot and s at the cell (i, r).  Pass 2 replaces K5's binary mode
(``build_sell8w_v2w_fn(binary=True)``).  :func:`prepare_coo2` places a
:class:`~spmv_tpu_torch.formats.coo2.Coo2` pack as ``build_coo2_fn`` does:
the pass-1 arrays padded to whole 16-tile groups, the values in bf16 when
every one round-trips, and R as a binary SELL stream.  On the H100 both
passes are bound by device-memory bytes (see the sources).  Pass 1 runs
one CUDA block a chunk of contiguous tiles (:func:`chunk_bounds`, the SELL
template's chunk rule), staging each tile and its x window in shared
memory with bulk copies: meta, values and x must be 16-B aligned.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.autograd import profiler as _torch_profiler

from .. import _build
from ..formats import _bf16
from ..formats.coo2 import Coo2
from ..formats.dia import is_lossless_bf16
from ..formats.sell8w import LANES, SUB, WINDOW
from ..utils import profiling
from ..utils.profiling import dev_put, launches
from . import sell as sell_ops

__all__ = ["Coo2Plan", "prepare_coo2", "coo2_pass1", "coo2_pass1_plain",
           "coo2_spmv", "chunk_bounds", "G1"]

#: pass-1 tiles per group: the tile count is padded to a multiple of it
G1 = 16


@dataclasses.dataclass(frozen=True)
class Coo2Plan:
    """Device arrays of one COO2 plan."""

    m: int
    n: int
    ntiles: int                   # pass-1 tiles, padded to a multiple of G1
    window_ids: torch.Tensor      # (ntiles,) int32
    meta: torch.Tensor            # (ntiles, 8, 128) int16
    vals: torch.Tensor            # (ntiles, 8, 128) f32 or bf16
    reduce: sell_ops.SellStream   # R, binary row mode, n = its positions
    chunk_ptr: torch.Tensor       # (nchunks + 1,) int32 pass-1 tile
    #                               bounds (chunk_bounds)

    def __post_init__(self):
        if self.meta.device.type != "cuda":
            return
        for t in (self.meta, self.vals, self.window_ids):
            if t.data_ptr() % 16:
                raise ValueError("coo2 plan: meta, values and window ids "
                                 "must be 16-B aligned for the kernel's "
                                 "bulk copies")


def chunk_bounds(ntiles: int, nsm: int) -> np.ndarray:
    """The (nchunks + 1,) int32 tile bounds of pass 1's chunks, one CUDA
    block a chunk: every chunk ``sell.chunk_len(ntiles, nsm)`` tiles long
    (about CHUNKS_PER_SM chunks an SM, at most CHUNK_TILES tiles) but the
    last, none empty."""
    step = sell_ops.chunk_len(ntiles, nsm)
    return np.append(np.arange(0, ntiles, step), ntiles).astype(np.int32)


def prepare_coo2(packed: Coo2, device) -> Coo2Plan:
    """Place a COO2 pack on ``device`` (``build_coo2_fn``'s arrays), with
    pass 1's chunks sized for the device's SMs (``H100_SMS`` on the CPU).
    Raises on the card when a bulk-copied array is not 16-B aligned."""
    ntiles = -(-packed.ntiles // G1) * G1
    lossless = is_lossless_bf16(packed.vals.reshape(-1))
    meta = np.zeros((ntiles, SUB, LANES), dtype=np.int16)
    vals = np.zeros((ntiles, SUB, LANES),
                    dtype=np.uint16 if lossless else np.float32)
    win = np.zeros(ntiles, dtype=np.int32)
    meta[:packed.ntiles] = packed.meta
    vals[:packed.ntiles] = (_bf16.from_f32(packed.vals) if lossless
                            else packed.vals)
    win[:packed.ntiles] = packed.window_ids
    return Coo2Plan(
        m=packed.m, n=packed.n, ntiles=ntiles,
        window_ids=dev_put(win, device), meta=dev_put(meta, device),
        vals=dev_put(_bf16.as_torch(vals) if lossless else vals, device),
        reduce=sell_ops.prepare_sell(
            sell_ops.binary_v2(packed.reduce_plan), device, slot_mode=False),
        chunk_ptr=dev_put(chunk_bounds(ntiles, sell_ops.sm_count(device)),
                          device))


def coo2_pass1_plain(p: Coo2Plan, x: torch.Tensor) -> torch.Tensor:
    """The plain version of pass 1: decode every slot's column, gather x
    (0 past n) and multiply.  Returns the (ntiles * 1024,) f32 products."""
    x = x.to(torch.float32)
    meta = p.meta.to(torch.int64) & 0xFFFF
    r = meta & 127
    s = (torch.gather(meta, 2, r) >> 7) & 7               # at the cell (i, r)
    col = p.window_ids.to(torch.int64)[:, None, None] * WINDOW + s * LANES + r
    xg = (torch.where(col < p.n, x[col.clamp(max=p.n - 1)], 0.0) if p.n
          else torch.zeros_like(col, dtype=torch.float32))
    return (p.vals.to(torch.float32) * xg).reshape(-1)


def coo2_pass1(p: Coo2Plan, x: torch.Tensor) -> torch.Tensor:
    """Pass 1 (the product stream).  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (K8, ``coo2_pass1`` in
    ``profiling.launches``); any other device raises.  x is f32.  Inside
    the span ``spmv.kernel.coo2_pass1``."""
    if _torch_profiler._is_profiler_enabled or profiling.record is not None:
        s = profiling.opening("spmv.kernel.coo2_pass1")
        if s is not None:
            with s:
                return coo2_pass1(p, x)
    if x.device.type == "cpu":
        return coo2_pass1_plain(p, x)
    if x.device.type != "cuda":
        raise ValueError(f"coo2_pass1: no kernel for device {x.device}")
    if (x.dtype != torch.float32 or x.shape != (p.n,)
            or not x.is_contiguous() or x.device != p.meta.device):
        raise ValueError(f"coo2_pass1: x must be a contiguous float32 "
                         f"({p.n},) tensor on {p.meta.device}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if x.data_ptr() % 16:
        x = x.clone()       # x windows are bulk-copied: 16-B aligned
    lib = _build.load_kernels()
    out = torch.empty(p.ntiles * WINDOW, dtype=torch.float32,
                      device=x.device)
    err = lib.spmv_coo2_launch(
        p.window_ids.data_ptr(), p.meta.data_ptr(), p.vals.data_ptr(),
        x.data_ptr(), p.chunk_ptr.data_ptr(), out.data_ptr(),
        p.chunk_ptr.numel() - 1, p.n, int(p.vals.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "coo2_pass1")
    launches["coo2_pass1"] += 1
    return out


def coo2_spmv(p: Coo2Plan, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x: pass 1, then the binary reduce over the first R.n
    products (a prefix view of the stream, no copy), cut to m rows."""
    prod = coo2_pass1(p, x)
    return sell_ops.sell_spmv(p.reduce, prod[:p.reduce.n])[:p.m]
