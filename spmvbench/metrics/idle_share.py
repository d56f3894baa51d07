"""The share (%) of the traced window in which no device activity ran:
100 · (1 − busy / window), both from the ``busy`` segment, which records
the card's activity and no host op: busy is the union of its device
activities, the window two CUDA events around its units.  One reader for
every cell (``idle_share.solve``, ``idle_share.chain``)."""


def read(rec):
    b = rec["busy"]
    if not b or not b["device_events"] or not b["window_s"]:
        return None
    return 100.0 * (1.0 - b["busy_s"] / b["window_s"])
