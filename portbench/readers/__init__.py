"""Per-layer readers: ``read(params, ctx) -> float | None``, one module a
kind of reading. ``ctx`` holds the traced segment's ``trace``
(``trace.TraceSummary``), ``unit_s`` (seconds a unit in the untraced
window), the traffic driver's ``work()``, the port's kernel names and ``on_card``.
A reader that finds nothing to read returns None, and the harness leaves
the metric out of the line."""
