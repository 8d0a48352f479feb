"""The measured program, ``rdfc_gan_torch``: its engine built from the
configuration file as its drivers build it, with the reference's seeded
weights loaded as a reference-schema state dict (as ``--load_from``
loads them), and the kernel launches it counts."""

from __future__ import annotations

from typing import Dict

import torch


def port_config(config: dict, batch: int, device: str):
    """The program's config: its defaults, the configuration's model and
    training settings, the cell's sizes."""
    from rdfc_gan_torch.config.config import default_config

    cfg = default_config()
    cfg.merge(dict(config["train"]))
    cfg.merge(dict(model=config["model"], out_height=config["out_height"],
                   out_width=config["out_width"],
                   num_classes=config["num_classes"], batch_size=batch,
                   device=device))
    return cfg


def build(config: dict, batch: int, device: str, train: bool,
          state: Dict[str, dict]):
    """The engine with ``state`` (net key -> state dict) loaded strictly;
    a train engine's schedules stay at their first epoch."""
    from rdfc_gan_torch.engines import build_engine

    cfg = port_config(config, batch, device)
    engine = build_engine(cfg, is_train=train, steps_per_epoch=10 ** 9)
    for key, net in engine.modules.items():
        net.load_state_dict(state[key], strict=True)
    return engine


def launches() -> Dict[str, int]:
    from rdfc_gan_torch.ops.kernels import build

    return dict(build.LAUNCHES)


def free(engine) -> None:
    engine.modules.clear()
    engine.optimizers.clear()
    engine.schedulers.clear()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
