"""Seconds of the pre-deal's ``predeal.place`` stage: the plan placed on
the card and bound, its synchronised transfers (``transfer_s``) included.
From ``predeal_profile``'s record of the traced run's ``create_handle``;
None for a port without it."""


def read(rec):
    return rec["predeal"].get("place_s")
