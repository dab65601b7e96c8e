"""One of the program's spans' share of its roofline, in %: the bound a
unit (``work[params["bound"]]`` seconds) over the device seconds a traced
unit of the span ``params["span"]``, from the CUDA events of the totals the
program keeps under the profiler (``aip_tpu_torch.utils.profiling``). None
where the program keeps no such totals or the span has no device time."""


def read(params, ctx):
    try:
        from aip_tpu_torch.utils.profiling import span_stats
    except ImportError:
        return None
    t = ctx["trace"]
    bound = ctx["work"].get(params["bound"])
    rec = span_stats().get(params["span"])
    if bound is None or not isinstance(rec, dict) or t.units == 0:
        return None
    device_s = rec.get("device_s")
    if not device_s:
        return None
    return 100.0 * bound / (device_s / t.units)
