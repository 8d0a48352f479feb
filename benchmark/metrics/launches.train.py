"""launches.train: device kernels a step in the traced slice (the
profiler's count)."""


def read(ctx):
    if ctx.trace is None or ctx.spec.traffic["driver"] != "train":
        return None
    return len(ctx.trace.kernels()) / ctx.trace.units
