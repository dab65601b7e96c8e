"""The device's idle share of the traced window, in %: 100 x (1 - busy /
window)."""


def read(params, ctx):
    t = ctx["trace"]
    if t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
