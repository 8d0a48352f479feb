"""The reference of a net of type ``PatchGANDiscriminator``:
``models.TorchPatchGAN``."""

from __future__ import annotations

from .. import models


def build(net: dict, cfg: dict):
    kw = {k: tuple(net[k]) for k in ("out_channels", "kernel_size", "stride",
                                     "padding") if k in net}
    return models.TorchPatchGAN(net.get("in_channels", 1), **kw)
