"""issue_ms.train: the median host time of the program's train step,
from the call to its return before any readback, over the window's
steps."""

import statistics


def read(ctx):
    if ctx.spec.traffic["driver"] != "train":
        return None
    return statistics.median(ctx.window["issue_s"]) * 1e3
