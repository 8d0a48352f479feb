"""Checkpoints. The port's checkpoint is the reference ``.pth``: a raw
generator state dict, or the reference multi-net schema with one
``{net}_state_dict`` entry per net and a ``meta`` dict
(lib/utils/checkpoint.py:27-30), e.g. the RDFCGAN's six nets G_A2B, G_B2A,
disc_A, disc_B, G_normal, G_label. It is read with ``weights_only=True`` (a
tensor-only load; full unpickling of a downloaded file could run arbitrary
code). An engine loads the nets it has and leaves the others unread: the
serving RDFCGAN reads G_A2B, G_normal and G_label. Optimizer state and
resume wait for a later slice."""

from __future__ import annotations

import os
from typing import Callable, Dict, Mapping, Optional, Union

import torch

Net = Union[torch.nn.Module, Mapping[str, torch.Tensor]]


def save_checkpoint(nets: Dict[str, Net], filename: str,
                    meta: Optional[Dict] = None):
    """Write ``{net}_state_dict`` for every module or state dict in
    ``nets`` (on the CPU) and ``meta`` (e.g. epoch, best), atomically."""
    obj = {}
    for name, net in nets.items():
        sd = net.state_dict() if isinstance(net, torch.nn.Module) else net
        obj[f"{name}_state_dict"] = {k: v.detach().cpu()
                                     for k, v in sd.items()}
    obj["meta"] = dict(meta or {})
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    tmp = f"{filename}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, filename)


def load_checkpoint(modules: Dict[str, torch.nn.Module], filename: str,
                    log: Optional[Callable[[str], None]] = None) -> Dict:
    """Load ``filename`` strictly into ``modules`` (keyed like the schema,
    e.g. {"G": generator}). A raw state dict goes to the only module. The
    file's nets that no module takes are left unread and named to ``log``.
    Returns the file's ``meta`` entry, or {}."""
    obj = torch.load(filename, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict):
        raise ValueError(f"{filename}: not a state dict")
    nets = {k[:-len("_state_dict")]: v for k, v in obj.items()
            if k.endswith("_state_dict")}
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
