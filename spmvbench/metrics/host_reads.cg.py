"""The solver's host reads a solve: ``solvers.host_syncs`` over every
solve of the run, traced and untraced, over their count."""


def read(rec):
    return rec["host_syncs"] / rec["attempted"] if rec["attempted"] else None
