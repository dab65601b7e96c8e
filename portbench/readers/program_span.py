"""Milliseconds a traced unit of one of the program's own spans, from the
totals it keeps under the profiler (``aip_tpu_torch.utils.profiling``):
``params["span"]``, and ``params["field"]`` one of ``host``, ``self_host``
(less the time of the spans inside it) or ``device`` (its CUDA events).
None where the program keeps no such totals, the span did not fire, or it
has no device time."""


def read(params, ctx):
    try:
        from aip_tpu_torch.utils.profiling import span_stats
    except ImportError:
        return None
    t = ctx["trace"]
    rec = span_stats().get(params["span"])
    if not isinstance(rec, dict) or t.units == 0:
        return None
    total = rec.get(f"{params['field']}_s")
    if total is None:
        return None
    return 1e3 * total / t.units
