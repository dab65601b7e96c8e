"""Device ms a unit of every device operation that is not one of the
port's own kernels (cuDNN convs, pads, elementwise passes, transposes,
copies)."""


def read(params, ctx):
    from portbench.trace import is_port_kernel

    t = ctx["trace"]
    s = sum(sec for name, (sec, _) in t.kernels.items()
            if not is_port_kernel(name, ctx["port_kernels"]))
    if t.units == 0 or not t.kernels:
        return None
    return 1e3 * s / t.units
