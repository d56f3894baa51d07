"""DIA SpMV: the kernel ``csrc/dia.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``spmv_tpu/ops/pallas_dia.py::_make_kernel`` (K3)
and takes over the XLA plan ``spmv_tpu/ops/xla_csr.py::dia_spmv``: one plan
for both, with no bound on m, n or the diagonal count (the JAX package's
``MAX_N``/``MAX_DIAGS`` gates sized VMEM).  On the H100 the kernel is bound
by device-memory bytes: the diagonal stream (2 B a slot in bf16, 4 B in
f32), plus x and y once each; see the source for the design.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import _build
from ..formats import _bf16
from ..formats.dia import DiaMatrix
from ..utils.profiling import dev_put

__all__ = ["DiaPlan", "prepare_dia", "dia_spmv", "dia_plain", "launches"]

#: kernel launches made by :func:`dia_spmv` (reset by callers that count)
launches = 0


@dataclasses.dataclass(frozen=True)
class DiaPlan:
    """Device arrays of one DIA plan."""

    m: int
    n: int
    offsets: Tuple[int, ...]      # host copy, sorted
    offsets_dev: torch.Tensor     # (ndiags,) int32
    data: torch.Tensor            # (ndiags, m) float32 or bfloat16


def prepare_dia(d: DiaMatrix, device) -> DiaPlan:
    """Place a packed :class:`DiaMatrix` (f32, or bf16 bits) on ``device``."""
    data = np.asarray(d.data)
    if data.dtype == np.uint16:
        data_t = _bf16.as_torch(data)
    elif data.dtype == np.float32:
        data_t = torch.from_numpy(np.ascontiguousarray(data))
    else:
        raise NotImplementedError(
            f"DIA data of dtype {data.dtype}: the f64 DIA kernel (K4) is "
            "not ported yet (ROADMAP.md, 'Next slices', item 1)")
    offsets = tuple(int(o) for o in d.offsets)
    return DiaPlan(
        m=d.m, n=d.n, offsets=offsets,
        offsets_dev=dev_put(np.asarray(offsets, dtype=np.int32), device),
        data=dev_put(data_t, device))


def dia_plain(p: DiaPlan, x: torch.Tensor) -> torch.Tensor:
    """The plain version: shifted-slice FMAs over a zero-padded x (the
    algebra of ``xla_csr.dia_spmv``), f32 accumulation."""
    x = x.to(torch.float32)
    acc = torch.zeros(p.m, dtype=torch.float32, device=x.device)
    if not p.offsets:
        return acc
    pad_l = max(0, -min(p.offsets))
    pad_r = max(0, p.m + max(p.offsets) - p.n)
    xpad = torch.cat([x.new_zeros(pad_l), x, x.new_zeros(pad_r)])
    for d, o in enumerate(p.offsets):
        acc += p.data[d].to(torch.float32) * xpad[pad_l + o: pad_l + o + p.m]
    return acc


def dia_spmv(p: DiaPlan, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel; any other device raises."""
    global launches
    if x.device.type == "cpu":
        return dia_plain(p, x)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmv: no kernel for device {x.device}")
    if (x.dtype != torch.float32 or x.shape != (p.n,)
            or not x.is_contiguous() or x.device != p.data.device):
        raise ValueError(f"dia_spmv: x must be a contiguous float32 ({p.n},) "
                         f"tensor on {p.data.device}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    lib = _build.load_kernels()
    y = torch.empty(p.m, dtype=torch.float32, device=x.device)
    err = lib.spmv_dia_launch(
        p.data.data_ptr(), p.offsets_dev.data_ptr(), x.data_ptr(),
        y.data_ptr(), p.m, p.n, len(p.offsets),
        int(p.data.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "dia")
    launches += 1
    return y
