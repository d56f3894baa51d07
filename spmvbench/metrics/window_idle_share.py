"""The share (%) of the untraced window's wall time in which the device
would be idle: 100 · (1 − busy a unit / wall a unit), busy a unit from the
``busy`` segment and wall a unit from the window.  The device's time a
unit does not depend on the profiler, but the host's pace does: under
CUPTI a CG set ran 1.1-1.8× slower on an H100, from run to run, and
``idle_share`` reads that slower pace.  One reader for every cell
(``window_idle_share.solve``, ``window_idle_share.chain``)."""


def read(rec):
    b, w = rec["busy"], rec["window"]
    if not b or not b["device_events"] or not w["units"]:
        return None
    return 100.0 * (1.0 - (b["busy_s"] / b["units"])
                    / (w["window_s"] / w["units"]))
