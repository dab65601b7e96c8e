"""Drivers: one module a kind of traffic. ``build(ctx)`` (``ctx`` a
``harness.Context``) returns an object with

* ``warm()``: set-up past building: every shape the window uses, once;
* ``unit() -> dict``: one timed unit of work (a batch, a step, a request, a
  frame), handed to the harness, which synchronises the card after it;
* ``end_to_end(records, window_s) -> dict``: the cell's end-to-end values
  from the window's per-unit records (``t0``, ``s`` and what ``unit``
  returned);
* ``notes(records, window_s) -> dict``: sample counts and the like, for the
  earlier line;
* ``work() -> dict``: operations, bytes and bounds a unit needs, for the
  per-layer readers;
* ``release()``: frees the program's state once the window has closed;
* ``check() -> {name: {"value", "limit"}}``: the comparison with the plain
  reference of what the window produced;
* ``control() -> {name: value}``: the same numbers with the reference, at
  the precision below the cell's, in the program's place (calibration and
  tests only; no benchmark run calls it).
"""
