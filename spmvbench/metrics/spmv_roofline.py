"""A product's share (%) of its bandwidth roofline in this cell
(``core.roofline_share``).  One reader for every cell
(``spmv_roofline.solve``, ``spmv_roofline.chain``)."""

from spmvbench.core import roofline_share


def read(rec):
    return roofline_share(rec)
