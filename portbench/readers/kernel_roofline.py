"""Kernels' share of their roofline, in %: the summed bound a unit
(``work[<key>]`` seconds, for each key of ``params["kernels"]``) over the
summed device time a unit of the kernels whose names hold the values."""


def read(params, ctx):
    t = ctx["trace"]
    bound = device = 0.0
    for key, pattern in params["kernels"].items():
        b = ctx["work"].get(key)
        s = t.kernel_s(pattern)
        if b is None or s is None or t.units == 0:
            return None
        bound += b
        device += s / t.units
    return 100.0 * bound / device if device > 0 else None
