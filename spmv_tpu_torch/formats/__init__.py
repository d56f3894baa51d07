"""Host-side format packers (jax-free copies of ``spmv_tpu.formats``)."""
from . import (_bf16, bcsr, coo2, csr_split, dia, reorder, sell8d, sell8w,
               sell_cs)
