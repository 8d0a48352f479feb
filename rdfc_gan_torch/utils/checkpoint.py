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

Over ranks rank 0 alone writes, and every rank waits at a barrier after
the write, so a resume on any rank reads a whole file; every rank reads.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Mapping, Optional, Union

import torch

from ..parallel import barrier, is_main

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


def _read(filename: str) -> dict:
    obj = torch.load(filename, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict):
        raise ValueError(f"{filename}: not a state dict")
    return obj


def _nets(obj: dict) -> Dict[str, dict]:
    return {k[:-len("_state_dict")]: v for k, v in obj.items()
            if k.endswith("_state_dict") and not k.endswith(_TRAIN_SUFFIXES)}


def load_checkpoint(modules: Dict[str, torch.nn.Module], filename: str,
                    log: Optional[Callable[[str], None]] = None) -> Dict:
    """Load ``filename`` strictly into ``modules`` (keyed like the schema,
    e.g. {"G": generator}). A raw state dict goes to the only module. The
    file's nets that no module takes are left unread and named to ``log``;
    optimizer and scheduler entries are not read. Returns the file's
    ``meta`` entry, or {}."""
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
    naming the first missing entry."""
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
