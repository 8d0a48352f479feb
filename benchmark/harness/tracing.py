"""The traced slice: a fixed number of requests or steps run under
``torch.profiler``, each inside a ``bench.unit`` range, reduced in memory
to device intervals by kernel name, the host ops around them, and the
slice's window (from the first unit's start to the last unit's end)."""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

UNIT = "bench.unit"


@dataclass
class Slice:
    units: int
    start_us: float
    end_us: float
    # (name, start us, end us) of every device activity: kernels, copies,
    # fills
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    # (name, start us, end us) of the host ops
    host: List[Tuple[str, float, float]] = field(default_factory=list)
    # launches the program counted (rdfc_gan_torch.ops.kernels.build)
    launches: Dict[str, int] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) * 1e-6

    def kernels(self) -> List[Tuple[str, float, float]]:
        return [d for d in self.device if not _is_copy(d[0])]

    def kernel_seconds(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.kernels()
                   if rx.search(n)) * 1e-6

    def kernel_names(self, pattern: str) -> List[str]:
        rx = re.compile(pattern)
        return sorted({n for n, _, _ in self.kernels() if rx.search(n)})

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device intervals, clipped to the window."""
        ivs = sorted((max(s, self.start_us), min(e, self.end_us))
                     for _, s, e in self.device
                     if e > self.start_us and s < self.end_us)
        out: List[List[float]] = []
        for s, e in ivs:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def top_device_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, s, e in self.device:
            by[name] = by.get(name, 0.0) + (e - s) * 1e-6
        return [[k[:200], v] for k, v in sorted(by.items(),
                                               key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest gaps in the device's union, each named by the
        innermost host op running at the gap's start."""
        busy = self.busy_intervals()
        edges = [self.start_us] + [x for iv in busy for x in iv] + \
            [self.end_us]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            name = "idle"
            best = None
            for hn, hs, he in self.host:
                if hs <= s < he and hn != UNIT and (best is None
                                                    or hs > best):
                    best, name = hs, hn
            out.append([name[:200], (e - s) * 1e-6])
        return out


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def record(run_unit: Callable[[int], None], units: int, sync: Callable,
           launches: Callable[[], Dict[str, int]]) -> Slice:
    """Run ``run_unit(i)`` for i < ``units`` under the profiler, each in
    its ``bench.unit`` range, the last ending in ``sync()``; reduce the
    trace. The slice ends at the last unit's end or its last device
    activity, whichever is later."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    before = dict(launches())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(units):
            with record_function(UNIT):
                run_unit(i)
                if i == units - 1:
                    sync()
    after = launches()
    sl = Slice(units=units, start_us=float("inf"), end_us=0.0)
    sl.launches = {k: after.get(k, 0) - before.get(k, 0) for k in after
                   if after.get(k, 0) != before.get(k, 0)}
    device = []
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type == DeviceType.CUDA:
            device.append((ev.name, float(tr.start), float(tr.end)))
        elif ev.name == UNIT:
            sl.start_us = min(sl.start_us, float(tr.start))
            sl.end_us = max(sl.end_us, float(tr.end))
        else:
            sl.host.append((ev.name, float(tr.start), float(tr.end)))
    # a host range's annotation on the device timeline is no device work
    ranges = {n for n, _, _ in sl.host} | {UNIT}
    sl.device = [d for d in device if d[0] not in ranges]
    if sl.device:
        sl.end_us = max(sl.end_us, max(e for _, _, e in sl.device))
    del torch
    return sl
