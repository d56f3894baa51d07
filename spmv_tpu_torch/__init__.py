"""spmv_tpu_torch: the PyTorch + CUDA port of tpu-spmv for NVIDIA Hopper.

The same inspect-once/execute-many SpMV API as ``spmv_tpu`` (the JAX
package, which stays the reference): ``create_handle(a, Method.AUTO,
device=...)`` then ``spmv(h, x)`` on torch tensors.  This slice runs the
f32 AUTO main path: DIA and the SELL-8W/SELL-8D tile streams through
hand-written CUDA kernels for ``sm_90a`` (``csrc/``), each with a plain
PyTorch version that CPU tensors take.  The package imports no JAX.
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
from .inspector import featurize, choose_method, MatrixFeatures
from . import io, formats, ops, utils

__version__ = "0.1.0"

__all__ = [
    "CsrMatrix", "Method", "VectorizedWay", "METHOD_NAMES", "VECTORIZED_NAMES",
    "spmv_golden", "rmse", "max_abs_err",
    "SpmvHandle", "create_handle", "spmv",
    "spmv_create_handle_all_in_one", "spmv_clear_handle",
    "spmv_destroy_handle", "spmv_destory_handle",
    "featurize", "choose_method", "MatrixFeatures",
    "__version__",
]
