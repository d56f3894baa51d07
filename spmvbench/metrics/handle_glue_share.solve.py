"""The share (%) of the device time inside the calls into the handle that
kernels other than the port's own (``spmv::``) take: the handle's folds,
rest and x-extension glue."""


def read(rec):
    t = rec["trace"]
    if not t or not t["spmv_device_s"]:
        return None
    return 100.0 * t["spmv_foreign_s"] / t["spmv_device_s"]
