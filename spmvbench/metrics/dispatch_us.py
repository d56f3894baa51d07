"""Host us a product: the ``spmv.product`` span's inclusive host seconds
over its count, from the port's span table after the run (the host's whole
side of one product: ``spmv()``'s checks and cast, the handle's closures
and glue, each kernel's allocation and launch).  One reader for
``dispatch_us.solve`` and ``dispatch_us.chain``."""

from spmvbench import spans


def read(rec, table=None):
    s = spans.mean_s(spans.table() if table is None else table,
                     "spmv.product")
    return None if s is None else s * 1e6
