"""The optimizer state of a JAX ``.ckpt`` (optax, through
``flax.serialization.to_state_dict``) <-> the port's torch optimizers and
``LambdaLR`` schedules (``engines.base.make_optimizer``).

The JAX ``make_optimizer`` (rdfc_gan_tpu/engines/base.py:103-151) chains,
in the optax the JAX package runs,

    adam     ({count, mu, nu}, {count})
    adamw    ({count, mu, nu}, {}, {count})
    sgd      ({}, {count})
    rmsprop  ({nu}, {count}, {})

each written as a map {"0": ..., "1": ...}; the last ``{count}`` is the
schedule's. ``clip_grad`` puts the chain one level down, under "1", beside
the clip's empty "0"; ``fused_optimizer`` (``optax.flatten``) keeps ``mu``
and ``nu`` as one flat vector over the group's parameters in JAX's leaf
order (dict keys sorted). An optimizer over several nets (the RDFCGAN's G
over G_A2B and G_B2A, D over disc_A and disc_B) sees {net: params}; one
over a single net sees that net's params.

``mu`` and ``nu`` have the params' trees, so they go through the net's
converter as its params do; the converters only rearrange values. Adam's
and AdamW's ``mu``, ``nu`` and ``count`` are each parameter's
``exp_avg``, ``exp_avg_sq`` and ``step``, RMSprop's ``nu`` is
``OptaxRMSprop``'s, SGD keeps none. A parameter with no JAX counterpart
(``fuse_layer5``, NNET's identity ``bn2``) gets an empty state, as after
training in the port (it never has a gradient); which names have one is
found by converting a tree of NaN. The schedule's count sets the
``LambdaLR``, so that the next step's learning rate is ``schedule(count)``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..utils.jax_checkpoint import sorted_tree
from .base import OptaxRMSprop

_LAYOUT = {"adam": ("stats", "sched"), "adamw": ("stats", "empty", "sched"),
           "sgd": ("empty", "sched"), "rmsprop": ("stats", "sched", "empty")}
# optax's moment -> the torch optimizer's state key
_MOMENTS = {"adam": {"mu": "exp_avg", "nu": "exp_avg_sq"},
            "adamw": {"mu": "exp_avg", "nu": "exp_avg_sq"},
            "rmsprop": {"nu": "nu"}, "sgd": {}}

# (engine net name, module, converter): from a params-shaped Flax tree to
# the module's state dict, or from the state dict (numpy) to that tree
FromTree = Callable[[Any], Dict[str, torch.Tensor]]
ToTree = Callable[[Dict[str, np.ndarray]], Any]


def optimizer_kind(opt: torch.optim.Optimizer) -> str:
    for cls, kind in ((torch.optim.AdamW, "adamw"), (torch.optim.Adam, "adam"),
                      (OptaxRMSprop, "rmsprop"), (torch.optim.SGD, "sgd")):
        if isinstance(opt, cls):
            return kind
    raise NotImplementedError(type(opt).__name__)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree) -> List[Any]:
    """The leaves in JAX's order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def unflatten(flat, like):
    """Split ``optax.flatten``'s vector into ``like``'s tree."""
    flat = np.asarray(flat)
    shapes = [np.shape(x) for x in _leaves(like)]
    sizes = [int(np.prod(s)) for s in shapes]
    if sum(sizes) != flat.size:
        raise ValueError(f"a flat optimizer vector of {flat.size} entries "
                         f"over {sum(sizes)} parameters")
    parts = iter(np.split(flat, np.cumsum(sizes)[:-1]))

    def take(x):
        return next(parts).reshape(np.shape(x))

    # the same sorted traversal as _leaves
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return take(t)

    return walk(like)


def flatten(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.float32).reshape(-1)
                           for x in _leaves(tree)])


def set_schedule(sched: torch.optim.lr_scheduler.LambdaLR, count: int):
    """The scheduler as after ``count`` steps: the next optimizer step runs
    at ``base_lr * lambda(count)``."""
    sched.last_epoch = int(count)
    opt = sched.optimizer
    for g, base, fn in zip(opt.param_groups, sched.base_lrs,
                           sched.lr_lambdas):
        g["lr"] = base * fn(int(count))
    sched._last_lr = [g["lr"] for g in opt.param_groups]


def _chain(state: dict, kind: str, clip: bool, what: str) -> dict:
    if clip:
        if sorted(state) != ["0", "1"] or state["0"]:
            raise ValueError(f"{what}: a clip_grad chain ({{}}, inner) "
                             f"expected, got keys {sorted(state)}")
        state = state["1"]
    layout = _LAYOUT[kind]
    if sorted(state) != [str(i) for i in range(len(layout))]:
        raise ValueError(f"{what}: optax {kind} has {len(layout)} chain "
                         f"entries, the file {sorted(state)}")
    return {role: state[str(i)] for i, role in enumerate(layout)}


def load_optimizer_state(opt: torch.optim.Optimizer,
                         sched: torch.optim.lr_scheduler.LambdaLR,
                         state: dict,
                         nets: Sequence[Tuple[str, torch.nn.Module,
                                              FromTree]],
                         params: Any, *, clip: bool, fused: bool,
                         what: str = "optimizer") -> int:
    """Restore ``opt`` and ``sched`` from one optimizer's optax state
    (``state``, a to_state_dict tree) over ``nets``; ``params`` is the
    group's params tree as optax saw it ({net: tree} for several nets),
    which places a fused vector's entries. Returns the schedule's
    count."""
    kind = optimizer_kind(opt)
    entries = _chain(state, kind, clip, what)
    count = int(np.asarray(entries["sched"]["count"]))
    stats = entries.get("stats", {})
    moments = {}
    for m in _MOMENTS[kind]:
        tree = stats[m]
        moments[m] = unflatten(tree, params) if fused else tree
    held = {p for g in opt.param_groups for p in g["params"]}
    step = torch.tensor(float(np.asarray(stats.get("count", count))),
                        dtype=torch.float32)
    for key, module, from_tree in nets:
        def own(tree):
            return tree[key] if len(nets) > 1 else tree

        probe = from_tree(_map(lambda x: np.full(np.shape(x), np.nan,
                                                 np.float32),
                               own(params)))
        mapped = {n for n, t in probe.items()
                  if t.is_floating_point() and bool(torch.isnan(t).all())}
        sds = {m: from_tree(own(tree)) for m, tree in moments.items()}
        for name, p in module.named_parameters():
            if p not in held:
                continue
            opt.state.pop(p, None)
            if name not in mapped or not sds:
                continue
            st = {} if kind == "rmsprop" else {"step": step.clone()}
            for m, tkey in _MOMENTS[kind].items():
                st[tkey] = sds[m][name].to(p.device, p.dtype).reshape(
                    p.shape).clone()
            opt.state[p] = st
    set_schedule(sched, count)
    return count


def optimizer_state_tree(opt: torch.optim.Optimizer,
                         sched: torch.optim.lr_scheduler.LambdaLR,
                         nets: Sequence[Tuple[str, torch.nn.Module, ToTree]],
                         *, clip: bool, fused: bool) -> dict:
    """One optimizer's state as the optax chain's to_state_dict tree, maps
    in the order flax writes them: each moment through the nets'
    converters (zeros where a parameter has no state), the counts int32."""
    kind = optimizer_kind(opt)
    moments = {m: {} for m in _MOMENTS[kind]}
    steps = [int(st["step"]) for st in opt.state.values() if "step" in st]
    for key, module, to_tree in nets:
        base = {k: v.detach().cpu().numpy()
                for k, v in module.state_dict().items()}
        for m, tkey in _MOMENTS[kind].items():
            sd = dict(base)
            for name, p in module.named_parameters():
                st = opt.state.get(p, {})
                sd[name] = (st[tkey].detach().float().cpu().numpy()
                            if tkey in st else np.zeros(tuple(p.shape),
                                                        np.float32))
            moments[m][key] = sorted_tree(to_tree(sd)["params"])
    for m, per_net in moments.items():
        tree = per_net if len(nets) > 1 else next(iter(per_net.values()))
        moments[m] = flatten(tree) if fused else tree
    count = np.asarray(sched.last_epoch, np.int32)
    entries = []
    for role in _LAYOUT[kind]:
        if role == "sched":
            entries.append({"count": count})
        elif role == "empty":
            entries.append({})
        elif kind == "rmsprop":
            entries.append({"nu": moments["nu"]})
        else:
            entries.append({"count": np.asarray(max(steps, default=0),
                                                np.int32),
                            "mu": moments["mu"], "nu": moments["nu"]})
    chain = {str(i): e for i, e in enumerate(entries)}
    return {"0": {}, "1": chain} if clip else chain
