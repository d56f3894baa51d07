"""Seconds of the traced run's pre-deal: ``create_handle`` to a
synchronise, under ``predeal_profile`` (its transfers each synchronised).
The pre-deal swings too widely from run to run for an end-to-end bound,
so it is read here, as ``predeal_s.traced``."""


def read(rec):
    return rec["predeal"]["total_s"]
