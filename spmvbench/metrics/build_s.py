"""Seconds of the pre-deal's ``predeal.build`` stage: the formats and the
native packers (``_build_plan``).  From ``predeal_profile``'s record of
the traced run's ``create_handle``; None for a port without it."""


def read(rec):
    return rec["predeal"].get("build_s")
