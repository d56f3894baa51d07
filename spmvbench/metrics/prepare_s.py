"""Seconds of the pre-deal's ``predeal.prepare`` stage: AUTO's
refinements, the heavy-tail probes (``prepare_hybrid``, the length-order
estimate, ``prepare_graph_split``); 0.0 where AUTO ran none.  From
``predeal_profile``'s record of the traced run's ``create_handle``; None
for a port without it."""


def read(rec):
    return rec["predeal"].get("prepare_s")
