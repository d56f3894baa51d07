"""DIA SpMV: the kernel ``csrc/dia.cu`` and its plain PyTorch version.

Replaces the TPU kernels ``spmv_tpu/ops/pallas_dia.py::_make_kernel`` (K3,
f32 and bf16 diagonals) and ``::_make_kernel_df`` (K4, f64 matrices), and
takes over the XLA plan ``spmv_tpu/ops/xla_csr.py::dia_spmv``: one plan
for all three, with no bound on m, n or the diagonal count (the JAX
package's ``MAX_N``/``MAX_N_DF``/``MAX_DIAGS`` gates sized VMEM).  An f64
plan keeps the pack's f64 diagonals as one plane and sums in native f64,
where K4 split them into (hi, lo) f32 planes.  On the H100 the kernel is
bound by device-memory bytes: the diagonal stream (2 B a slot in bf16, 4 B
in f32, 8 B in f64), plus x and y once each; see the source for the design.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch.autograd import profiler as _torch_profiler

from .. import _build
from ..formats import _bf16
from ..formats.dia import DiaMatrix
from ..utils import profiling
from ..utils.profiling import dev_put, launches

__all__ = ["DiaPlan", "prepare_dia", "dia_spmv", "dia_plain"]

_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}


@dataclasses.dataclass(frozen=True)
class DiaPlan:
    """Device arrays of one DIA plan."""

    m: int
    n: int
    offsets: Tuple[int, ...]      # host copy, sorted
    offsets_dev: torch.Tensor     # (ndiags,) int32
    data: torch.Tensor            # (ndiags, m) float32, bfloat16 or float64

    @property
    def dtype(self) -> torch.dtype:
        """The type of x and y: f64 for an f64 plan, else f32."""
        return (torch.float64 if self.data.dtype == torch.float64
                else torch.float32)


def prepare_dia(d: DiaMatrix, device) -> DiaPlan:
    """Place a packed :class:`DiaMatrix` (f32, f64, or bf16 bits) on
    ``device``."""
    data = np.asarray(d.data)
    if data.dtype == np.uint16:
        data_t = _bf16.as_torch(data)
    elif data.dtype in (np.float32, np.float64):
        data_t = torch.from_numpy(np.ascontiguousarray(data))
    else:
        raise ValueError(f"DIA data of dtype {data.dtype} has no kernel")
    offsets = tuple(int(o) for o in d.offsets)
    return DiaPlan(
        m=d.m, n=d.n, offsets=offsets,
        offsets_dev=dev_put(np.asarray(offsets, dtype=np.int32), device),
        data=dev_put(data_t, device))


def dia_plain(p: DiaPlan, x: torch.Tensor) -> torch.Tensor:
    """The plain version: shifted-slice FMAs over a zero-padded x (the
    algebra of ``xla_csr.dia_spmv``), accumulated in the plan's type."""
    x = x.to(p.dtype)
    acc = torch.zeros(p.m, dtype=p.dtype, device=x.device)
    if not p.offsets:
        return acc
    pad_l = max(0, -min(p.offsets))
    pad_r = max(0, p.m + max(p.offsets) - p.n)
    xpad = torch.cat([x.new_zeros(pad_l), x, x.new_zeros(pad_r)])
    for d, o in enumerate(p.offsets):
        acc += p.data[d].to(p.dtype) * xpad[pad_l + o: pad_l + o + p.m]
    return acc


def dia_spmv(p: DiaPlan, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (K3 on f32/bf16 plans, ``dia`` in
    ``profiling.launches``; K4 on f64 plans, ``dia_f64``); any other device
    raises.  x is f64 for an f64 plan, else f32.  Inside the span
    ``spmv.kernel.dia`` or ``spmv.kernel.dia_f64``."""
    if _torch_profiler._is_profiler_enabled or profiling.record is not None:
        name = ("spmv.kernel.dia_f64" if p.data.dtype == torch.float64
                else "spmv.kernel.dia")
        s = profiling.opening(name)
        if s is not None:
            with s:
                return dia_spmv(p, x)
    if x.device.type == "cpu":
        return dia_plain(p, x)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmv: no kernel for device {x.device}")
    if (x.dtype != p.dtype or x.shape != (p.n,)
            or not x.is_contiguous() or x.device != p.data.device):
        raise ValueError(f"dia_spmv: x must be a contiguous {p.dtype} "
                         f"({p.n},) tensor on {p.data.device}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    lib = _build.load_kernels()
    y = torch.empty(p.m, dtype=p.dtype, device=x.device)
    f64 = p.data.dtype == torch.float64
    err = lib.spmv_dia_launch(
        p.data.data_ptr(), p.offsets_dev.data_ptr(), x.data_ptr(),
        y.data_ptr(), p.m, p.n, len(p.offsets), _KINDS[p.data.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    name = "dia_f64" if f64 else "dia"
    _build.check(lib, err, name)
    launches[name] += 1
    return y
