"""idle_pct.serve: the share of the traced slice's time in which no
operation ran on the device (the union of the device's intervals, not
their sum)."""


def read(ctx):
    if ctx.trace is None or ctx.spec.traffic["driver"] != "serve":
        return None
    return ctx.trace.idle_pct()
