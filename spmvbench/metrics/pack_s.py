"""Seconds of the pre-deal on the host: ``create_handle`` under
``predeal_profile`` less its synchronised transfers (router, host pack)."""


def read(rec):
    p = rec["predeal"]
    if "transfer_s" not in p:
        return None
    return p["total_s"] - p["transfer_s"]
