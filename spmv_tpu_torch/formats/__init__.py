"""Host-side format packers (jax-free copies of ``spmv_tpu.formats``)."""
from . import _bf16, bcsr, dia, reorder, sell8d, sell8w
