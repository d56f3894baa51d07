"""spmv_tpu_torch: the PyTorch + CUDA port of tpu-spmv for NVIDIA Hopper.

The same inspect-once/execute-many SpMV API as ``spmv_tpu`` (the JAX
package, which stays the reference): ``create_handle(a, Method.AUTO,
device=...)`` then ``spmv(h, x)`` on torch tensors.  The port runs the
f32 and f64 AUTO main path and Method.CSR5: DIA, the SELL-8W/SELL-8D tile
streams and the two-pass COO2 plan through hand-written CUDA kernels for
``sm_90a`` (``csrc/``), each with a plain PyTorch version that CPU
tensors take.  f64 matrices compute in native f64; bf16 matrices
(``CsrMatrix(..., vals=<torch.bfloat16 tensor>)`` or ``astype(
torch.bfloat16)``) take the JAX planner's bf16 routes and give f32 y.
``parallel`` holds the
mesh plans; ``tune``, ``solvers``, ``io.mmio`` and ``bench`` (timing and
the CSV suite) are the execute-many layer on top.  The package imports no
JAX.
"""

from .types import CsrMatrix, Method, VectorizedWay, METHOD_NAMES, VECTORIZED_NAMES
from .oracle import spmv_golden, rmse, max_abs_err
from .handle import (
    SpmvHandle,
    create_handle,
    spmv,
    spmv_create_handle_all_in_one,
    spmv_clear_handle,
    spmv_destroy_handle,
    spmv_destory_handle,
)
from .inspector import featurize, choose_method, tune, MatrixFeatures
from . import io, formats, ops, parallel, bench, solvers, utils

__version__ = "0.1.0"

__all__ = [
    "CsrMatrix", "Method", "VectorizedWay", "METHOD_NAMES", "VECTORIZED_NAMES",
    "spmv_golden", "rmse", "max_abs_err",
    "SpmvHandle", "create_handle", "spmv",
    "spmv_create_handle_all_in_one", "spmv_clear_handle",
    "spmv_destroy_handle", "spmv_destory_handle",
    "featurize", "choose_method", "tune", "MatrixFeatures",
    "solvers",
    "__version__",
]
