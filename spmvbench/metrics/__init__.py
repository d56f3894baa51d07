"""Per-layer metric readers, one a module named as the metric, found by
``BENCHMARK.json``'s ``per_layer`` names.  Each has ``read(rec)``, which
returns the metric from the traced run's record, or None when the record
holds nothing to read it from.  ``rec`` holds ``predeal`` (``total_s``,
and ``transfer_s`` and ``bytes`` from ``predeal_profile``),
``host_syncs`` (``solvers.host_syncs`` over every unit of the run),
``attempted`` (those units), ``window``
(the untraced window's ``units``, ``products``, ``window_s``), ``busy``
(the card-only segment's ``busy_s``, ``window_s``, ``device_events`` and
``units``, or None), ``trace`` (the ranges segment: ``devtrace.reduce``'s
numbers, or None), ``least_bytes`` (a product's) and
``peak_bytes_per_s`` (the card's published bandwidth, None for a card the
table lacks)."""
