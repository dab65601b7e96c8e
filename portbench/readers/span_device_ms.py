"""Device ms a unit of the kernels launched under one ``record_function``
span (``params["span"]``)."""


def read(params, ctx):
    t = ctx["trace"]
    s = t.spans.get(params["span"])
    if s is None or t.units == 0:
        return None
    return 1e3 * s / t.units
