"""Seconds of the pre-deal's transfers to the card, each synchronised
(``predeal_profile``'s ``transfer_s``)."""


def read(rec):
    return rec["predeal"].get("transfer_s")
