"""Device ms a solve outside the calls into the handle: the solver loop's
dots and axpys, or the PageRank step's vector ops."""


def read(rec):
    t = rec["trace"]
    if not t or not t["units"] or not t["device_events"]:
        return None
    return t["outside_spmv_s"] / t["units"] * 1e3
