"""Seconds of the pre-deal's ``predeal.inspect`` stage: routing by the
matrix's features (``choose_method``).  From ``predeal_profile``'s record
of the traced run's ``create_handle``; None for a port without it."""


def read(rec):
    return rec["predeal"].get("inspect_s")
