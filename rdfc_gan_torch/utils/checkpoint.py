"""Checkpoints. The port's checkpoint is the reference ``.pth``
(lib/utils/checkpoint.py:7-168; SURVEY.md 2.8): one ``{net}_state_dict``
entry per net (e.g. the RDFCGAN's six: G_A2B, G_B2A, disc_A, disc_B,
G_normal, G_label), and, from a training run, ``{k}_optimizer_state_dict``
and ``{k}_lr_scheduler_state_dict`` for each optimizer ``k`` of the engine
(RDFCGAN: G, D, Nor, label; RDFGAN: G, D), plus ``meta`` {epoch,
batch_size, ...}. A raw generator state dict is read too. Files are read
with ``weights_only=True`` (a tensor-only load; full unpickling of a
downloaded file could run arbitrary code).

``load_checkpoint`` loads the nets an engine has and leaves the others
unread (the serving RDFCGAN reads G_A2B, G_normal and G_label).
``resume_from`` restores a training engine whole: nets, optimizers,
schedulers and the global step, so that a resumed run replays the straight
run's stream of per-step draws.

The JAX drivers' ``.ckpt`` (``utils.jax_checkpoint``: the RDFCTPU2
header and the flax msgpack of the GANTrainState) is read too: both entry
points tell the two formats apart by the file's first 8 bytes, never by
its suffix. Its nets go through ``utils.convert.net_state_dict_from_jax``
with the engine config's options (``cfg``); ``load_checkpoint`` leaves its
optimizer states unread, as the JAX ``test.py`` does; ``resume_from`` maps
them onto the port's optimizers and schedules
(``engines.optax_state``), takes the global step from the state's
``step`` and the epoch from ``meta`` (a file without one resumes at epoch
0 with a warning and keeps its step, as the JAX ``resume_from`` does).
``save_jax_checkpoint`` writes a training engine's whole state in that
format, the tree the JAX engine's template holds, which the JAX drivers
read: every engine the port builds, the v1 driver's among them.

Over ranks rank 0 alone writes, and every rank waits at a barrier after
the write, so a resume on any rank reads a whole file; every rank reads.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch

from ..parallel import barrier, is_main
from . import jax_checkpoint

Net = Union[torch.nn.Module, Mapping[str, torch.Tensor]]
_TRAIN_SUFFIXES = ("_optimizer_state_dict", "_lr_scheduler_state_dict")


def _cpu(obj):
    """``obj`` with every tensor moved to the CPU (dicts, lists, tuples
    walked)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def save_checkpoint(nets: Dict[str, Net], filename: str,
                    meta: Optional[Dict] = None,
                    train_state: Optional[Dict] = None):
    """Write ``{net}_state_dict`` for every module or state dict in
    ``nets``, the entries of ``train_state`` (an engine's
    ``train_state()``), all on the CPU, and ``meta``, atomically; over
    ranks rank 0 writes and all wait for it."""
    if not is_main():
        barrier()
        return
    obj = {}
    for name, net in nets.items():
        sd = net.state_dict() if isinstance(net, torch.nn.Module) else net
        obj[f"{name}_state_dict"] = _cpu(dict(sd))
    obj.update(_cpu(dict(train_state or {})))
    obj["meta"] = dict(meta or {})
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    tmp = f"{filename}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, filename)
    barrier()


def _is_jax(filename: str) -> bool:
    """The file's format by its first 8 bytes: a JAX ``.ckpt`` (True), a
    ``torch.save`` zip or legacy pickle (False); anything else raises
    ValueError naming the file."""
    with open(filename, "rb") as f:
        head = f.read(8)
    if head in (jax_checkpoint.MAGIC, jax_checkpoint.MAGIC_V1):
        return True
    if head.startswith(b"PK\x03\x04") or head[:1] == b"\x80":
        return False
    raise ValueError(f"{filename} is neither a JAX checkpoint "
                     f"({jax_checkpoint.MAGIC!r}) nor a torch.save file: it "
                     f"starts with {head!r}")


def _read(filename: str) -> dict:
    obj = torch.load(filename, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict):
        raise ValueError(f"{filename}: not a state dict")
    return obj


def _nets(obj: dict) -> Dict[str, dict]:
    return {k[:-len("_state_dict")]: v for k, v in obj.items()
            if k.endswith("_state_dict") and not k.endswith(_TRAIN_SUFFIXES)}


def _jax_nets(modules: Dict[str, torch.nn.Module], filename: str, tree,
              cfg, log) -> None:
    """Load the nets of a JAX state ``tree`` into ``modules``. A module
    entry the tree lacks (``fuse_layer5``, an eval-mode tree's aux head)
    keeps its value and is named to ``log``; an entry the module lacks
    raises."""
    from .convert import net_state_dict_from_jax

    if cfg is None:
        raise ValueError(f"{filename} is a JAX checkpoint: its nets are "
                         f"converted with the engine's config (cfg=...)")
    params, stats = tree["params"], tree["batch_stats"]
    for name, mod in modules.items():
        if name not in params:
            raise KeyError(f"{filename} has no {name} params")
        sd = net_state_dict_from_jax(cfg, name, mod, params[name],
                                     stats.get(name, {}))
        res = mod.load_state_dict(sd, strict=False)
        if res.unexpected_keys:
            raise KeyError(f"{filename}: {name} has no "
                           f"{', '.join(res.unexpected_keys)}")
        if res.missing_keys and log is not None:
            log(f"{os.path.basename(filename)}: {name} keeps its own "
                f"{', '.join(res.missing_keys)}")
    unread = sorted(set(params) - set(modules))
    if unread and log is not None:
        log(f"{os.path.basename(filename)}: left unread "
            + ", ".join(unread))


def load_checkpoint(modules: Dict[str, torch.nn.Module], filename: str,
                    log: Optional[Callable[[str], None]] = None,
                    cfg=None) -> Dict:
    """Load ``filename`` strictly into ``modules`` (keyed like the schema,
    e.g. {"G": generator}). A raw state dict goes to the only module. The
    file's nets that no module takes are left unread and named to ``log``;
    optimizer and scheduler entries are not read. A JAX ``.ckpt`` needs
    the engine's config ``cfg``. Returns the file's ``meta`` entry, or
    {}."""
    if _is_jax(filename):
        tree, meta = jax_checkpoint.read_state(filename)
        _jax_nets(modules, filename, tree, cfg, log)
        return meta
    obj = _read(filename)
    nets = _nets(obj)
    if not nets:
        if len(modules) != 1:
            raise ValueError(f"{filename}: a raw state dict needs exactly one "
                             f"module, got {sorted(modules)}")
        nets = {next(iter(modules)): obj}
    for name, mod in modules.items():
        if name not in nets:
            raise KeyError(f"{filename} has no {name}_state_dict")
        mod.load_state_dict(nets[name], strict=True)
    unread = sorted(set(nets) - set(modules))
    if unread and log is not None:
        log(f"{os.path.basename(filename)}: left unread "
            + ", ".join(f"{n}_state_dict" for n in unread))
    meta = obj.get("meta", {})
    return meta if isinstance(meta, dict) else {}


def resume_from(engine, filename: str) -> int:
    """Restore a training engine from a checkpoint it (or a straight run of
    the same configuration) wrote: every net, each optimizer's and
    scheduler's state, and ``engine.n_step`` = epoch x steps per epoch.
    Returns the epoch to start from (``meta["epoch"]``). Raises KeyError
    naming the first missing entry. A JAX ``.ckpt`` goes to
    ``_resume_jax``."""
    if _is_jax(filename):
        return _resume_jax(engine, filename)
    obj = _read(filename)
    nets = _nets(obj)
    for name in engine.modules:
        if name not in nets:
            raise KeyError(f"{filename} has no {name}_state_dict")
    meta = obj.get("meta")
    if not isinstance(meta, dict) or "epoch" not in meta:
        raise KeyError(f"{filename} has no meta epoch: nothing to resume")
    epoch = int(meta["epoch"])
    engine.load_train_state(obj, start_step=epoch * engine.steps_per_epoch)
    for name, mod in engine.modules.items():
        mod.load_state_dict(nets[name], strict=True)
    return epoch


def _opt_groups(engine):
    """{optimizer: the engine nets it steps}, as the JAX engine groups its
    optax states (rdfc_gan_tpu/engines/rdfc_gan.py:146-153, rdf_gan.py:
    71-76)."""
    return getattr(engine, "OPT_NETS", {k: (k,) for k in engine.optimizers})


def _resume_jax(engine, filename: str) -> int:
    from ..engines.optax_state import load_optimizer_state
    from .convert import net_state_dict_from_jax

    tree, meta = jax_checkpoint.read_state(filename)
    _jax_nets(engine.modules, filename, tree, engine.cfg, None)
    opt_states, params, stats = (tree["opt_states"], tree["params"],
                                 tree["batch_stats"])
    cfg = engine.cfg
    for k, opt in engine.optimizers.items():
        if k not in opt_states:
            raise KeyError(f"{filename} has no {k} optimizer state: it "
                           f"cannot resume training")
        names = _opt_groups(engine)[k]
        nets = []
        for n in names:
            mod = engine.modules[n]
            nets.append((n, mod, lambda t, n=n, mod=mod:
                         net_state_dict_from_jax(cfg, n, mod, t,
                                                 stats.get(n, {}))))
        group = ({n: params[n] for n in names} if len(names) > 1
                 else params[names[0]])
        load_optimizer_state(
            opt, engine.schedulers[k], opt_states[k], nets, group,
            clip=bool(cfg.get("clip_grad", False)),
            fused=bool(cfg.get("fused_optimizer", False)),
            what=f"{filename} {k}")
    engine.n_step = int(np.asarray(tree["step"]))
    epoch = meta.get("epoch")
    if epoch is None:
        logging.getLogger(__name__).warning(
            "checkpoint %s has no epoch metadata; resuming with "
            "start_epoch=0 (the restored step %d keeps the schedule's "
            "position)", filename, engine.n_step)
        epoch = 0
    return int(epoch)


def jax_state_tree(engine) -> dict:
    """The engine's state as the JAX GANTrainState's to_state_dict tree,
    maps in the order flax writes them: step (int32), params and
    batch_stats per net, and each optimizer's optax state."""
    from ..engines.optax_state import optimizer_state_tree
    from .torch_convert import net_tree_to_jax

    cfg = engine.cfg
    params, stats, to_tree = {}, {}, {}
    for name, mod in engine.modules.items():
        to_tree[name] = (lambda sd, name=name, mod=mod:
                         net_tree_to_jax(cfg, name, mod, sd))
        t = to_tree[name]({k: v.detach().cpu().numpy()
                           for k, v in mod.state_dict().items()})
        params[name], stats[name] = t["params"], t["batch_stats"]
    opt_states = {}
    for k, opt in engine.optimizers.items():
        opt_states[k] = optimizer_state_tree(
            opt, engine.schedulers[k],
            [(n, engine.modules[n], to_tree[n])
             for n in _opt_groups(engine)[k]],
            clip=bool(cfg.get("clip_grad", False)),
            fused=bool(cfg.get("fused_optimizer", False)))
    return {"step": np.asarray(getattr(engine, "n_step", 0), np.int32),
            "params": jax_checkpoint.sorted_tree(params),
            "batch_stats": jax_checkpoint.sorted_tree(stats),
            "opt_states": {k: opt_states[k] for k in sorted(opt_states)}}


def save_jax_checkpoint(engine, filename: str, meta: Optional[Dict] = None):
    """Write the engine's whole state as the JAX drivers' ``.ckpt``, which
    the JAX ``load_checkpoint`` / ``resume_from`` read into the JAX
    engine's template (the v1 driver's too, ``tools/main_v1.py``); over
    ranks rank 0 writes and all wait for it."""
    if not is_main():
        barrier()
        return
    jax_checkpoint.write_state(filename, jax_state_tree(engine), meta)
    barrier()
