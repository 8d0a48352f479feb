"""Closed-loop serving: one client sends a batch from the pool, waits for
every returned map on the host, and sends the next, for the window's
seconds. Each request is timed from its inputs on the host to its maps on
the host; the issue span is the program's call alone, before the
readback. After the window a sample of the pool's batches, drawn from the
seed, is compared with the reference: the maps the window last returned
for each."""

from __future__ import annotations

import random
import time

import torch

from reference import engines, weights

from . import data, port, tracing
from .common import process_age_s


def _maps(out: dict) -> dict:
    return {k: v for k, v in out.items()
            if isinstance(v, torch.Tensor) and v.dim() == 4}


def run(ctx, device, seconds: float, trace: bool, wrap=None) -> dict:
    """Set up, measure, trace, and compare; returns the compared numbers.
    ``wrap(engine)`` replaces the served call (a planted fault)."""
    spec, seed = ctx.spec, ctx.seed
    cfg, tr = spec.config, spec.traffic
    B, H, W = ctx.batch, ctx.height, ctx.width
    P = int(tr["pool"])
    pool = data.batch_pool(seed, P, B, H, W, train=False)
    probe = data.to_device(pool[0], device)
    nets, scale = weights.make(cfg, False, seed, device,
                               probe=(probe["rgb"], probe["raw_depth"]))
    engine = port.build(cfg, B, device, False,
                        {k: n.state_dict() for k, n in nets.items()})
    del nets, probe
    serve = wrap(engine) if wrap else engine.forward_test
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)

    def request(i):
        b = pool[i % P]
        t0 = time.perf_counter()
        rgb, raw = b["rgb"].to(device), b["raw_depth"].to(device)
        t1 = time.perf_counter()
        out = serve(rgb, raw)
        t2 = time.perf_counter()
        host = {k: v.cpu() for k, v in _maps(out).items()}
        return host, time.perf_counter() - t0, t2 - t1

    for i in range(int(tr["warmup_requests"])):
        request(i)
    sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ctx.setup_s = process_age_s()
    last, lats, issues = {}, [], []
    start = time.perf_counter()
    n = 0
    while time.perf_counter() - start < seconds:
        host, lat, iss = request(n)
        last[n % P] = host
        lats.append(lat)
        issues.append(iss)
        n += 1
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    ctx.window = dict(units=n, seconds=window_s, latencies_s=lats,
                      issue_s=issues, peak_bytes=peak, images=n * B)
    if trace:
        ctx.trace = tracing.record(lambda j: request(n + j),
                                   int(tr["trace_requests"]), sync,
                                   port.launches)
    port.free(engine)
    del engine, serve
    return compare(ctx, device, pool, last, scale)


def compare(ctx, device, pool, got: dict, scale,
            control: str = None) -> dict:
    """``<map>_err``: the largest |got - reference| over max |reference|,
    and ``<map>_rms``: the norm of got - reference over the reference's
    norm, of each map, the worst over a sample of the pool's batches. A map
    that the reference conditions (``Engine.conditioning``) also gets
    ``<map>_cerr``: the largest of each pixel's |got - reference| (over
    channels) times that pixel's weight, over max |reference|. ``got``
    maps a pool index to its host maps; with ``control`` the reference in
    that precision stands in for them."""
    spec, seed = ctx.spec, ctx.seed
    k = int(spec.traffic["check_batches"])
    picks = sorted(random.Random(seed).sample(sorted(got), min(k, len(got))))
    nets, _ = weights.make(spec.config, False, seed, device, scale=scale)
    ref = engines.Engine(spec.config, nets)
    low = engines.Engine(spec.config, nets, precision_name=control or "f32")
    worst = {}
    for j in picks:
        b = data.to_device(pool[j], device)
        want = _maps(ref.forward_test(b["rgb"], b["raw_depth"]))
        cond = {k2: c.cpu() for k2, c in ref.conditioning(b["rgb"]).items()}
        if control is None:
            have = got[j]
        else:
            have = {k2: v.cpu() for k2, v in _maps(
                low.forward_test(b["rgb"], b["raw_depth"])).items()}
        for name, w in want.items():
            w = w.float().cpu()
            h = have.get(name)
            keys = (f"{name}_err", f"{name}_rms") + (
                (f"{name}_cerr",) if name in cond else ())
            if h is None or h.shape != w.shape:
                errs = (float("inf"),) * len(keys)
            else:
                d = h.float() - w
                top = w.abs().max().clamp_min(1e-30)
                errs = (float(d.abs().max() / top),
                        float(d.norm() / w.norm().clamp_min(1e-30)))
                if name in cond:
                    errs += (float((d.abs().amax(1, keepdim=True)
                                    * cond[name]).max() / top),)
            for key, err in zip(keys, errs):
                if err != err:  # NaN
                    err = float("inf")
                worst[key] = max(worst.get(key, 0.0), err)
    return worst
