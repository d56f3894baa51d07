"""The plain reference that decides ``correct``: PyTorch only, and nothing
of ``spmv_tpu_torch`` or of the JAX package.  It works everything out again
from the generated arrays the port was handed."""
