"""Matrix generators, one a module, found by a configuration's
``generator`` key.  Each has ``generate(cfg, seed, device) -> dict`` with ``m``,
``n``, ``rowptr`` and ``colidx`` (int32) and ``vals`` in the
configuration's dtype, all numpy on the host (``device`` is where a
generator may draw and sort)."""
