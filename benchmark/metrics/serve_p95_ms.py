"""serve_p95_ms: the 95th percentile of every request's latency in the
window, from its inputs on the host to every returned map on the host."""

import statistics


def read(ctx):
    lats = ctx.window.get("latencies_s")
    if not lats or len(lats) < 2:
        return None
    return statistics.quantiles(lats, n=100)[94] * 1e3
