"""The program's own spans in a traced slice (``tracing.Slice``). The port
opens named ``record_function`` ranges (``rdfc.serve``, one per served net,
``rdfc.nlspn_block``: ``rdfc_gan_torch/utils/profiling.span``); the
profiler records them as host events on the clock of its device events.
So a slice splits by span:

  * ``span_intervals``: the union of a span's host intervals;
  * ``stall_us``: the device's idle time (the slice's window less the
    union of its device intervals) while the host was inside the span;
  * ``stall_outside_us``: the same inside one span and outside others
    (the served call's own code, outside its nets);
  * ``launch_calls``: the runtime and driver launch calls that started
    inside the span;
  * ``launch_us``: the host time in those calls inside the span.

Each returns None where the slice holds no event of the span (a program
that opens none). ``per_request`` hands a metric's reader one of them over
the slice's requests; ``serve_slice`` is the traced serve slice or None."""

from __future__ import annotations

from typing import List, Optional, Tuple

# kernel launches as the profiler names the CUDA runtime's and driver's
# calls
LAUNCH_CALLS = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC",
                          "cuLaunchKernel", "cuLaunchKernelEx",
                          "cudaLaunchCooperativeKernel"))

Intervals = List[Tuple[float, float]]


# _union and idle_intervals mirror tracing.Slice.busy_intervals and the
# head of tracing.Slice.idle_gaps; a change to either is made in both
def _union(ivs) -> Intervals:
    out: List[List[float]] = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _overlap_us(a: Intervals, b: Intervals) -> float:
    """The length of the intersection of two unions (sorted, disjoint)."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _minus(a: Intervals, b: Intervals) -> Intervals:
    """The union ``a`` less the union ``b`` (both sorted, disjoint)."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if e > s:
            out.append((s, e))
    return out


def span_intervals(sl, name: str) -> Optional[Intervals]:
    """The union of the host intervals of the span ``name``, clipped to
    the slice's window; None where the slice has no such span."""
    ivs = [(max(s, sl.start_us), min(e, sl.end_us))
           for n, s, e in sl.host if n == name]
    return _union(ivs) if ivs else None


def idle_intervals(sl) -> Intervals:
    """The slice's window less the union of its device intervals."""
    edges = [sl.start_us] + [x for iv in sl.busy_intervals() for x in iv] \
        + [sl.end_us]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def stall_us(sl, name: str) -> Optional[float]:
    """Microseconds in which the device ran nothing while the host was
    inside the span ``name``."""
    ivs = span_intervals(sl, name)
    return None if ivs is None else _overlap_us(idle_intervals(sl), ivs)


def stall_outside_us(sl, name: str, inner) -> Optional[float]:
    """Microseconds in which the device ran nothing while the host was
    inside the span ``name`` and inside none of the spans ``inner``; None
    where the slice has ``name`` or every one of ``inner`` missing."""
    ivs = span_intervals(sl, name)
    nested = [iv for n in inner for iv in (span_intervals(sl, n) or [])]
    if ivs is None or not nested:
        return None
    return _overlap_us(idle_intervals(sl), _minus(ivs, _union(nested)))


def _launches(sl, ivs: Intervals):
    return [(s, e) for n, s, e in sl.host if n in LAUNCH_CALLS
            and any(lo <= s < hi for lo, hi in ivs)]


def launch_calls(sl, name: str) -> Optional[int]:
    """Launch calls that started inside the span ``name``."""
    ivs = span_intervals(sl, name)
    return None if ivs is None else len(_launches(sl, ivs))


def launch_us(sl, name: str) -> Optional[float]:
    """Microseconds of host time in launch calls inside the span ``name``
    (the calls' union, cut to the span)."""
    ivs = span_intervals(sl, name)
    if ivs is None:
        return None
    return _overlap_us(_union(_launches(sl, ivs)), ivs)


def host_us(sl, name: str) -> Optional[float]:
    """Microseconds of the span ``name``'s union."""
    ivs = span_intervals(sl, name)
    return None if ivs is None else sum(e - s for s, e in ivs)


def serve_slice(ctx):
    """The run's traced slice where the cell serves; else None."""
    if ctx.trace is None or ctx.spec.traffic["driver"] != "serve":
        return None
    return ctx.trace


def per_request(ctx, reduce, name: str, scale: float = 1.0, *args):
    """``reduce(slice, name, *args)`` times ``scale`` a request of the
    traced serve slice; None without one, or without the span."""
    sl = serve_slice(ctx)
    v = None if sl is None else reduce(sl, name, *args)
    return None if v is None else v * scale / sl.units
