#!/usr/bin/env python3
"""The readings that a cell's limits are set from, beside those of the
program's own runs: the control (the reference in the program's place,
one precision below what the configuration states: TF32 below the f32
served path, fp8 below the bf16 train step) and, for a train cell, the
fault of a batch half left out (the mean over the rest), planted in the
reference in the program's place, on each seed, at the cell's own sizes.
A state left unchanged reads 1 by the change comparison and is not run.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]
    python3 benchmark/control.py --pair <config> <traffic> --program \
        --seeds <n> [<n> ...]

prints one JSON line a seed. It runs no window: the serve control reads
the pool's batches, the train control replays the checked steps, and
``--program`` adds the program's own checked steps on a train cell's
seeds, set up as a run sets them up. Not run by the benchmark's own
runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))


def readings(spec, seed: int, device, program: bool = False) -> dict:
    from harness import common, data, serve, train
    from reference import weights

    ctx = common.Ctx(spec=spec, seed=seed)
    cfg, tr = spec.config, spec.traffic
    B, H, W = ctx.batch, ctx.height, ctx.width
    P = int(tr["pool"])
    is_train = tr["driver"] == "train"
    pool = data.batch_pool(seed, P, B, H, W, train=is_train,
                           classes=cfg["num_classes"])
    probe = data.to_device(pool[0], device)
    nets, scale = weights.make(cfg, is_train, seed, device,
                               probe=(probe["rgb"], probe["raw_depth"]),
                               probe_train=is_train)
    del nets, probe
    if not is_train:
        got = {j: None for j in range(P)}
        return {"control_tf32": serve.compare(ctx, device, pool, got, scale,
                                              control="tf32")}
    ref = train.replay(ctx, device, pool, scale, "f32")
    out = {}
    if program:
        out["program"] = train.run(common.Ctx(spec=spec, seed=seed), device,
                                   0.0, False)
    return {**out, "control_fp8": train.compare(
                train.replay(ctx, device, pool, scale, "fp8"), ref),
            "fault_half_batch": train.compare(
                train.replay(ctx, device, pool, scale, "f32",
                             half_batch=True), ref)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--workload", help="a cell of BENCHMARK.json")
    what.add_argument("--pair", nargs=2, metavar=("CONFIG", "TRAFFIC"),
                      help="a configuration and a traffic mix that no "
                      "cell pairs yet")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true",
                    help="a train cell: also the program's own checked "
                    "steps on each seed, with no window")
    args = ap.parse_args(argv)
    import torch

    from harness import common

    spec = common.load_spec(args.workload) if args.workload else \
        common.pair_spec(*args.pair)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        out = readings(spec, seed, dev, args.program)
        print(json.dumps(dict(workload=spec.cell["name"], seed=seed, **out)),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
