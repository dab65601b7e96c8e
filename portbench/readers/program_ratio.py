"""One of the program's own counters over another, in %:
100 x ``params["numerator"]`` / ``params["denominator"]``, from the totals
it keeps under the profiler (``aip_tpu_torch.utils.profiling``). None where
the program keeps no such counters or the denominator did not count."""


def read(params, ctx):
    try:
        from aip_tpu_torch.utils.profiling import span_stats
    except ImportError:
        return None
    stats = span_stats()
    a, b = stats.get(params["numerator"]), stats.get(params["denominator"])
    if not isinstance(a, (int, float)) or not isinstance(b, (int, float)) or b <= 0:
        return None
    return 100.0 * a / b
