"""issue_ms.serve: the median host time of the program's served call,
from the call to its return before the readback, over the window's
requests."""

import statistics


def read(ctx):
    if ctx.spec.traffic["driver"] != "serve":
        return None
    return statistics.median(ctx.window["issue_s"]) * 1e3
