"""The whole unit's share of a published peak, in %: the unit's counted
operations (``work[params["flops"]]``) over (seconds a unit in the
untraced window x the peak ``params["peak"]``). A card's number only."""

from portbench.roofline import peaks


def read(params, ctx):
    flops = ctx["work"].get(params["flops"])
    if not ctx["on_card"] or not flops or ctx["unit_s"] <= 0:
        return None
    return 100.0 * flops / (ctx["unit_s"] * peaks.BY_NAME[params["peak"]])
