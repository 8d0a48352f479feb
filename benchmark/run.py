#!/usr/bin/env python3
"""The benchmark of ``rdfc_gan_torch`` on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout. The cell's configuration, traffic mix and
limits are the files that ``BENCHMARK.json`` names (``benchmark/configs``,
``benchmark/traffic``, ``benchmark/workloads``); each metric is read by
``benchmark/metrics/<name>.py``. One run sets up (weights and inputs from
the seed, the kernels built or loaded from the package's build cache, the
cell's shapes warmed up), measures for ``--seconds``, with ``--trace 1``
then profiles a fixed slice of requests or steps, compares what the timed
path produced with the plain reference of ``benchmark/reference``, and
prints one JSON result line last on standard output: the end-to-end
metrics with ``--trace 0``, the per-layer ones with ``--trace 1``.

It exits non-zero, printing no result, without as many CUDA devices as the
cell takes, and when JAX or the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(1, ROOT)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(spec, seed: int, seconds: float, trace: bool, device,
             wrap=None):
    """Run one cell on ``device``; returns (result line, checks)."""
    import torch

    from harness import common, serve, train

    ctx = common.Ctx(spec=spec, seed=seed)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ctx.unit_flops = flop_count(spec)
    driver = {"serve": serve, "train": train}[spec.traffic["driver"]]
    readings = driver.run(ctx, device, seconds, trace, wrap)
    found = common.forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    for name in sorted(readings):
        print(f"reading {name} {readings[name]!r}", file=sys.stderr)
    ok, checks = common.judge(readings, spec.limits)
    failed = int(ctx.window.get("failed", 0))
    metrics = common.metric_values(
        spec.per_layer if trace else spec.end_to_end, ctx)
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
               count=spec.chips,
               memory_peak_bytes=int(ctx.window["peak_bytes"]))
    result = dict(correct=bool(ok and failed == 0),
                  attempted=int(ctx.window["units"]), failed=failed,
                  metrics=metrics, device=dev)
    if trace and ctx.trace is not None:
        dev.update(busy_s=ctx.trace.busy_s(), window_s=ctx.trace.window_s)
        result["breakdown"] = dict(device_ops=ctx.trace.top_device_ops(),
                                   idle_gaps=ctx.trace.idle_gaps())
        for family, names in trace_kernel_families(ctx).items():
            print(f"kernels of {family}: {names}", file=sys.stderr)
        print(f"launches counted by the program in the slice of "
              f"{ctx.trace.units}: {ctx.trace.launches}", file=sys.stderr)
    return result, checks


def trace_kernel_families(ctx):
    from harness import common

    out = {}
    for fam in sorted(os.listdir(os.path.join(HERE, "roofline"))):
        if fam.endswith(".py"):
            mod = common.roofline_family(fam[:-3])
            out[fam[:-3]] = ctx.trace.kernel_names(mod.KERNELS)
    return out


def flop_count(spec) -> float:
    """Model FLOPs of one request or step, counted over the reference on
    the meta device, kept in ``benchmark/.cache`` under the configuration
    file's and the reference's hash."""
    import hashlib
    import json

    from reference import flops

    train = spec.traffic["driver"] == "train"
    h = hashlib.sha256(json.dumps(spec.config, sort_keys=True).encode())
    # every file of the reference, its subfolders' too
    for d, dirs, files in os.walk(os.path.join(HERE, "reference")):
        dirs.sort()
        for name in sorted(f for f in files if f.endswith(".py")):
            path = os.path.join(d, name)
            h.update(os.path.relpath(path, HERE).encode())
            with open(path, "rb") as f:
                h.update(f.read())
    key = f"{spec.config['name']}-{spec.traffic['batch']}-" \
          f"{'train' if train else 'serve'}-{h.hexdigest()[:16]}"
    cache = os.path.join(HERE, ".cache", "flops.json")
    try:
        with open(cache) as f:
            known = json.load(f)
    except (OSError, ValueError):
        known = {}
    if key not in known:
        known[key] = flops.count(spec.config, spec.config["train"],
                                 int(spec.traffic["batch"]), train)
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        tmp = cache + ".tmp"
        with open(tmp, "w") as f:
            json.dump(known, f)
        os.replace(tmp, cache)
    return float(known[key])


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None) -> int:
    args = parse(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(HERE, ".cache", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(HERE, ".cache", "torch_extensions"))
    from harness import common

    try:
        spec = common.load_spec(args.workload, ROOT)
    except common.SpecError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec.chips:
        print(f"benchmark: {args.workload} takes {spec.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f": no result", file=sys.stderr)
        return 3
    torch.set_num_threads(min(4, torch.get_num_threads()))
    try:
        result, checks = run_cell(spec, args.seed, args.seconds,
                                  bool(args.trace), torch.device("cuda", 0))
    except ForbiddenModules as e:
        print(f"benchmark: modules of JAX or the JAX package are loaded: "
              f"{e.args[0]}; no result", file=sys.stderr)
        return 4
    common.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
