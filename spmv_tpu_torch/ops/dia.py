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

from .. import _build
from ..formats import _bf16
from ..formats.dia import DiaMatrix
from ..utils.profiling import dev_put
from . import kernel

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
    #: its kernel's name in ``profiling.launches``: ``dia_f64`` (K4) for
    #: f64 diagonals, else ``dia`` (K3)
    kernel: str = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "kernel", "dia_f64" if self.data.dtype
                           == torch.float64 else "dia")

    @property
    def dtype(self) -> torch.dtype:
        """The type of x and y: f64 for an f64 plan, else f32."""
        return (torch.float64 if self.data.dtype == torch.float64
                else torch.float32)

    @property
    def device(self) -> torch.device:
        return self.data.device


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


@kernel("dia_spmv", dia_plain)
def dia_spmv(p: DiaPlan, x: torch.Tensor, stream: int) -> torch.Tensor:
    """y = A @ x.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (K3 on f32/bf16 plans, ``dia`` in
    ``profiling.launches``; K4 on f64 plans, ``dia_f64``); any other device
    raises.  x is f64 for an f64 plan, else f32.  Inside the span
    ``spmv.kernel.dia`` or ``spmv.kernel.dia_f64`` (``ops.kernel``)."""
    y = torch.empty(p.m, dtype=p.dtype, device=x.device)
    _build.launch(p.kernel, "spmv_dia_launch", p.data.data_ptr(),
                  p.offsets_dev.data_ptr(), x.data_ptr(), y.data_ptr(), p.m,
                  p.n, len(p.offsets), _KINDS[p.data.dtype], stream)
    return y
