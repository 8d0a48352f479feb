"""Training: set-up builds the program's engine with the reference's
seeded weights and drives it through its first three steps with the
window's own call and feed, on distinct batches of the pool; the window
then runs steps on the pool's batches, each copied from the host, the
losses read back once it closes. The first three steps are then replayed
by the reference from the same weights, batches and draws, and compared:
each step's G and D losses, each leaf's first gradient as the optimizer
got it (Adam's first moment after one step over 1 - beta1) and each
leaf's change over the three steps."""

from __future__ import annotations

import math
import statistics
import sys
import time

import torch

from reference import engines, weights

from . import data, port, tracing
from .common import process_age_s

CHECKED_STEPS = 3
# leaves whose reference gradient is under this share of the median
# leaf's move by round-off alone under Adam: left out of the gradient and
# change comparisons
GRAD_FLOOR = 1e-3


def totals(losses: dict) -> dict:
    """The step's G and D losses from its logged terms."""
    g = losses.get("loss_G")
    if g is None:
        g = losses["loss_G_GAN"] + sum(v for k, v in losses.items()
                                      if k.startswith("loss_L1_"))
    d = losses.get("loss_D")
    if d is None:
        d = losses["loss_D_A"] + losses["loss_D_B"]
    return {"G": float(g), "D": float(d)}


def first_grad_tensors(optimizers: dict, names: dict) -> dict:
    """Each leaf's first-step gradient, as its optimizer got it (Adam's
    first moment after one step over 1 - beta1), copied to the host."""
    out = {}
    for opt in optimizers.values():
        for group in opt.param_groups:
            beta1 = group["betas"][0]
            for p in group["params"]:
                st = opt.state.get(p, {})
                if "exp_avg" in st:
                    out[names[id(p)]] = (st["exp_avg"].double()
                                         / (1.0 - beta1)).cpu()
    return out


def first_grads(optimizers: dict, names: dict) -> dict:
    """Each leaf's first-step gradient norm from its optimizer's state."""
    return {n: float(torch.linalg.vector_norm(g)) for n, g in
            first_grad_tensors(optimizers, names).items()}


def named_params(nets: dict) -> dict:
    return {f"{k}.{n}": p for k, m in nets.items()
            for n, p in m.named_parameters() if p.requires_grad}


def changes(params: dict, before: dict) -> dict:
    return {n: float(torch.linalg.vector_norm((p.detach() - before[n])
                                              .double()))
            for n, p in params.items()}


def keep_shapes(nets: dict, batch: int):
    psp = nets.get("G_label")
    if psp is None:
        return None
    if hasattr(psp, "dropout_shapes"):
        return psp.dropout_shapes(batch)
    return ((batch, psp.master_branch[0].bottleneck[0].out_channels, 1, 1),
            (batch, psp.auxiliary_branch[0].out_channels, 1, 1))


def run(ctx, device, seconds: float, trace: bool, wrap=None) -> dict:
    """Set up, measure, trace, and compare; returns the compared numbers.
    ``wrap(engine)`` replaces the step call (a planted fault)."""
    spec, seed = ctx.spec, ctx.seed
    cfg, tr = spec.config, spec.traffic
    B, H, W = ctx.batch, ctx.height, ctx.width
    P = int(tr["pool"])
    pool = data.batch_pool(seed, P, B, H, W, train=True,
                           classes=cfg["num_classes"])
    probe = data.to_device(pool[0], device)
    nets, scale = weights.make(cfg, True, seed, device,
                               probe=(probe["rgb"], probe["raw_depth"]),
                               probe_train=True)
    engine = port.build(cfg, B, device, True,
                        {k: n.state_dict() for k, n in nets.items()})
    del nets, probe
    shapes = keep_shapes(engine.modules, B)
    step_fn = wrap(engine) if wrap else engine.train_step
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)

    issue = []

    def step(i):
        b = data.to_device(pool[i % P], device)
        kw = {} if shapes is None else dict(draws=data.step_draws(
            seed, i, B, H, W, shapes, device))
        t0 = time.perf_counter()
        out = step_fn(b, **kw)
        issue.append(time.perf_counter() - t0)
        return out

    params = named_params(engine.modules)
    names = {id(p): n for n, p in params.items()}
    before = {n: p.detach().clone() for n, p in params.items()}
    prog = dict(losses=[])
    for i in range(CHECKED_STEPS):
        prog["losses"].append(step(i))
        if i == 0:
            prog["grad_tensors"] = first_grad_tensors(engine.optimizers,
                                                      names)
            prog["terms"] = {k: float(v) for k, v in
                             prog["losses"][0].items()}
    prog["changes"] = changes(params, before)
    prog["losses"] = [totals(x) for x in prog["losses"]]
    del before
    sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ctx.setup_s = process_age_s()
    logs = []
    del issue[:]
    start = time.perf_counter()
    n = CHECKED_STEPS
    while time.perf_counter() - start < seconds:
        logs.append(step(n))
        n += 1
    sync()
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    window_losses = [totals(x) for x in logs]
    units = len(logs)
    failed = sum(1 for x in window_losses
                 if not all(math.isfinite(v) for v in x.values()))
    ctx.window = dict(units=units, seconds=window_s, peak_bytes=peak,
                      images=units * B, failed=failed,
                      issue_s=issue[:units])
    if trace:
        ctx.trace = tracing.record(lambda j: step(n + j),
                                   int(tr["trace_steps"]), sync,
                                   port.launches)
    port.free(engine)
    del engine, step_fn, params, names
    ref = replay(ctx, device, pool, scale, "f32")
    return compare(prog, ref)


def replay(ctx, device, pool, scale, precision_name: str,
           half_batch: bool = False) -> dict:
    """The reference's first three steps from the seed's weights on the
    pool's first batches and the same draws, in ``precision_name``;
    ``half_batch`` leaves the second half of each batch out (a fault)."""
    spec, seed = ctx.spec, ctx.seed
    cfg = spec.config
    B, H, W = ctx.batch, ctx.height, ctx.width
    nets, _ = weights.make(cfg, True, seed, device, scale=scale)
    eng = engines.Engine(cfg, nets, cfg["train"],
                         precision_name=precision_name)
    eng.make_optimizers()
    params = named_params(nets)
    names = {id(p): n for n, p in params.items()}
    before = {n: p.detach().clone() for n, p in params.items()}
    shapes = keep_shapes(nets, B)
    out = dict(losses=[])
    for i in range(CHECKED_STEPS):
        b = data.to_device(pool[i % len(pool)], device)
        d = None if shapes is None else data.step_draws(seed, i, B, H, W,
                                                        shapes, device)
        if half_batch:
            h = B // 2
            b = {k: v[:h] for k, v in b.items()}
            if d is not None:
                d = dict(pepper=(d["pepper"][0], d["pepper"][1][:h]),
                         keep=tuple(x[:h] for x in d["keep"]))
        losses = eng.train_step(b, d)
        out["losses"].append(totals(losses))
        if i == 0:
            out["grad_tensors"] = first_grad_tensors(eng.optimizers, names)
            out["terms"] = {k: float(v) for k, v in losses.items()}
    out["changes"] = changes(params, before)
    del eng, nets, params, before
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _leaf_gaps(got: dict, want: dict, floor_of: dict) -> list:
    """(gap, leaf) of each leaf whose reference gradient passes the floor:
    |norm - reference norm| over the larger of the reference's norm of
    that leaf and of the median leaf; worst first."""
    med = statistics.median(want.values())
    gmed = statistics.median(floor_of.values())
    out = []
    for name, w in want.items():
        if floor_of.get(name, 0.0) < GRAD_FLOOR * gmed:
            continue
        g = got.get(name)
        gap = float("inf") if g is None or not math.isfinite(g) else \
            abs(g - w) / max(w, med, 1e-30)
        out.append((gap, name))
    return sorted(out, reverse=True)


def compare(prog: dict, ref: dict) -> dict:
    """Each number of a train cell, program (or control) against the
    reference:
      loss_gap: the worst checked step's |loss - reference| / |reference|
        over G and D; d_loss_gap: step 1's D loss's;
      grad_gap, change_gap: the worst leaf's gap of norms
        (``_leaf_gaps``); grad_gap_median: the median leaf's;
      grad_diff_median: the median leaf's |g - reference g| / |reference
        g| of its first gradient, over the same leaves.
    The steps' losses and the three worst leaves go to stderr."""
    for side in (prog, ref):
        side.setdefault("grads", {n: float(torch.linalg.vector_norm(g))
                                  for n, g in side["grad_tensors"].items()})
    loss_gap = 0.0
    for i, (a, b) in enumerate(zip(prog["losses"], ref["losses"])):
        print(f"train check step {i + 1}: G {a['G']!r} reference "
              f"{b['G']!r}, D {a['D']!r} reference {b['D']!r}",
              file=sys.stderr)
        for k in ("G", "D"):
            gap = abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
            loss_gap = max(loss_gap, gap if math.isfinite(gap)
                           else float("inf"))
    a, b = prog["losses"][0]["D"], ref["losses"][0]["D"]
    d_gap = abs(a - b) / max(abs(b), 1e-30)
    out = dict(loss_gap=loss_gap,
               d_loss_gap=d_gap if math.isfinite(d_gap) else float("inf"))
    for k, b in ref["terms"].items():
        a = prog["terms"].get(k, float("nan"))
        gap = abs(a - b) / max(abs(b), 1e-30)
        out[f"loss1_gap.{k}"] = gap if math.isfinite(gap) else float("inf")
    for key, what in (("grads", "grad_gap"), ("changes", "change_gap")):
        gaps = _leaf_gaps(prog[key], ref[key], ref["grads"])
        out[what] = gaps[0][0] if gaps else float("inf")
        if key == "grads":
            out["grad_gap_median"] = statistics.median(
                g for g, _ in gaps) if gaps else float("inf")
            diffs = []
            for _, name in gaps:
                g = prog["grad_tensors"].get(name)
                w = ref["grad_tensors"][name]
                d = float("inf") if g is None else float(
                    torch.linalg.vector_norm(g - w)
                    / torch.linalg.vector_norm(w).clamp_min(1e-300))
                diffs.append(d if math.isfinite(d) else float("inf"))
            out["grad_diff_median"] = statistics.median(diffs) \
                if diffs else float("inf")
        for gap, name in gaps[:3]:
            print(f"train check {what} {gap!r} {name}: "
                  f"{prog[key].get(name)!r} reference {ref[key][name]!r}",
                  file=sys.stderr)
    return out
