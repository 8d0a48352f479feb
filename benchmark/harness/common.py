"""What every run shares: the cell's files found by name, the process's
age, the device line, the metric readers, the check of what the run
compared, the scan for JAX in ``sys.modules`` and the result line."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "rdfc_gan_tpu")

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s, f32
# FLOP/s outside the tensor cores, f64 FLOP/s, bf16 tensor-core FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12
PEAK_BF16_FLOPS = 989e12


class SpecError(RuntimeError):
    """A cell, configuration, traffic mix or metric that cannot be found or
    read."""


def load_json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except OSError as e:
        raise SpecError(f"cannot read {os.path.relpath(path, ROOT)}: {e}")


@dataclass
class Spec:
    """One cell: its entry in BENCHMARK.json, its configuration file, its
    traffic mix, its own file (limits) and the metrics it reports."""

    cell: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    chips: int


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_spec(cell_name: str, root: str = ROOT) -> Spec:
    """Find the cell's files by the names in ``BENCHMARK.json``:
    ``configs/<config>.json``, ``traffic/<traffic>.json`` and
    ``workloads/<cell>.json``."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise SpecError(f"no workload {cell_name!r} in BENCHMARK.json; "
                        f"have {sorted(cells)}")
    cell = cells[cell_name]
    here = os.path.join(root, "benchmark")
    config = load_json(os.path.join(here, "configs", cell["config"] + ".json"))
    traffic = load_json(os.path.join(here, "traffic",
                                     cell["traffic"] + ".json"))
    own = load_json(os.path.join(here, "workloads", cell_name + ".json"))
    return Spec(cell=cell, config=config, traffic=traffic,
                limits=own["limits"],
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, cell_name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, cell_name)],
                chips=int(cell["chips"]))


def pair_spec(config: str, traffic: str, root: str = ROOT) -> Spec:
    """A configuration under a traffic mix that no cell pairs yet, on one
    card, with no limits and no metrics (``control.py``'s readings)."""
    here = os.path.join(root, "benchmark")
    return Spec(cell=dict(name=f"{config}.{traffic}", config=config,
                          traffic=traffic, chips=1),
                config=load_json(os.path.join(here, "configs",
                                              config + ".json")),
                traffic=load_json(os.path.join(here, "traffic",
                                               traffic + ".json")),
                limits={}, end_to_end=[], per_layer=[], chips=1)


def load_module(path: str, name: str):
    """Import the file ``path`` as a module named ``name``."""
    if not os.path.isfile(path):
        raise SpecError(f"no file {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric_name: str):
    """The ``read(ctx)`` of ``metrics/<metric_name>.py``."""
    mod = load_module(os.path.join(BENCH, "metrics", metric_name + ".py"),
                      "bench_metric_" + metric_name.replace(".", "_")
                      .replace("-", "_"))
    return mod.read


def roofline_family(family: str):
    """The module ``roofline/<family>.py``: ``KERNELS`` (a regular
    expression over device kernel names) and ``work(ctx)`` (bytes, FLOPs
    and the peak FLOP/s of each launch of one request or step)."""
    return load_module(os.path.join(BENCH, "roofline", family + ".py"),
                       "bench_roofline_" + family)


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat's start
    time against /proc/uptime)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    each compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclass
class Ctx:
    """What a run hands the metric readers."""

    spec: Spec
    seed: int
    setup_s: float = 0.0
    # the window: "units" (requests or steps), "seconds", "latencies_s",
    # "issue_s", "peak_bytes", "images"
    window: Dict[str, Any] = field(default_factory=dict)
    # model FLOPs of one unit (the reference, counted on the meta device)
    unit_flops: float = 0.0
    # the traced slice (``tracing.Slice``), or None
    trace: Any = None

    @property
    def batch(self) -> int:
        return int(self.spec.traffic["batch"])

    @property
    def height(self) -> int:
        return int(self.spec.config["out_height"])

    @property
    def width(self) -> int:
        return int(self.spec.config["out_width"])

    def roofline_pct(self, family: str) -> Optional[float]:
        """The family's least time over its device time in the traced
        slice, in %; None where no kernel of it ran there."""
        if self.trace is None:
            return None
        fam = roofline_family(family)
        device_s = self.trace.kernel_seconds(fam.KERNELS)
        if device_s <= 0.0:
            return None
        least = 0.0
        for n_bytes, n_flops, peak in fam.work(self):
            least += max(n_bytes / PEAK_BYTES_S, n_flops / peak)
        return 100.0 * least * self.trace.units / device_s


def metric_values(metrics: List[dict], ctx: Ctx) -> Dict[str, dict]:
    """Each metric's reading by its reader; a reader that finds nothing
    (None) leaves its metric out."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(ctx)
        if value is None:
            continue
        if not math.isfinite(value):
            raise RuntimeError(f"metric {m['name']} read {value}")
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    """Each compared number beside its limit; correct when every number is
    finite and at or under its limit, and every limit was read."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = readings.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        checks[name] = {"value": v if v is None or math.isfinite(v)
                        else str(v), "limit": limit}
    return ok, checks


def emit(result: dict, checks: dict):
    """The comparison's lines last on stderr, then the result line last on
    stdout with ``checks`` as its last key."""
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["checks"] = checks
    print(json.dumps(line), flush=True)
