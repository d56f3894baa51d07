"""Host ms a solve blocked on the card in the solver's reads: the
``solver.read`` span's inclusive host seconds over the ``solver.solve``
span's count, from the port's span table after the run
(``read_wait_ms.cg``)."""

from spmvbench import spans


def read(rec, table=None):
    t = spans.table() if table is None else table
    r, s = t.get("solver.read"), t.get("solver.solve")
    if not r or not s or not s["count"]:
        return None
    return r["inclusive_s"] / s["count"] * 1e3
