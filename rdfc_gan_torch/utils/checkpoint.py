"""Checkpoints. The port's checkpoint is the reference ``.pth``: a raw
generator state dict, or the reference multi-net schema with one
``{net}_state_dict`` entry per engine module and a ``meta`` dict
(lib/utils/checkpoint.py:27-30), read with ``weights_only=True`` (a
tensor-only load; full unpickling of a downloaded file could run arbitrary
code). Optimizer state and resume wait for a later slice."""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch


def save_checkpoint(modules: Dict[str, torch.nn.Module], filename: str,
                    meta: Optional[Dict] = None):
    """Write ``{net}_state_dict`` for every module (on the CPU) and
    ``meta`` (e.g. epoch, best), atomically."""
    obj = {f"{name}_state_dict": {k: v.detach().cpu()
                                  for k, v in mod.state_dict().items()}
           for name, mod in modules.items()}
    obj["meta"] = dict(meta or {})
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    tmp = f"{filename}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, filename)


def load_checkpoint(modules: Dict[str, torch.nn.Module],
                    filename: str) -> Dict:
    """Load ``filename`` strictly into ``modules`` (keyed like the schema,
    e.g. {"G": generator}). A raw state dict goes to the only module.
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
    meta = obj.get("meta", {})
    return meta if isinstance(meta, dict) else {}
