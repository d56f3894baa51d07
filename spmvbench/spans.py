"""The port's span table (``spmv_tpu_torch.utils.profiling.spans()``), as
the span readers in ``metrics/`` take it after a run.  The port's spans
are live only while a profiler records, so in a ``--trace 1`` run the
table holds the two profiled segments' spans, and the pre-deal's.  A port
without the table (before the spans were added) gives an empty one."""


def table() -> dict:
    try:
        from spmv_tpu_torch.utils.profiling import spans
    except ImportError:
        return {}
    return spans()


def mean_s(table: dict, name: str):
    """The span's inclusive host seconds over its count, or None where the
    table lacks it."""
    s = table.get(name)
    if not s or not s["count"]:
        return None
    return s["inclusive_s"] / s["count"]
